// The thin-slab Taylor factors on Hopper: a batched complex64 GEMM with a
// one-matrix epilogue, and a one-pass Paterson-Stockmeyer chunk sum.
//
// Replaces: metalens_tpu/solver/pallas_taylor.py::_taylor_kernel, which
// evaluates the cos / sinc / R series of Y0 = F G (sharing Y0's powers by
// Paterson-Stockmeyer chunking, t^{2k} folded into the coefficient table)
// and the wrapper products S F, G S and G (R F), all in one VMEM-resident
// kernel per matrix.  A block's 227 KB cannot hold that working set at
// n = 100 (over 1 MB), so the host wrapper (solver/taylor.py) runs it in
// stages: Y0 and its powers P_m = P_{m-1} Y0 (m <= s) by cgemm_ps_c64; all
// 3 r chunk matrices
//
//     K[p][j] = sum_{m < s} coef[b, p, j s + m] P_m      (P_0 = I)
//
// by one pass of ps_chunks_c64 over the stored powers; the Horner steps
// acc = acc P_s + K[p][j] of each series, starting from its top chunk, by
// cgemm_ps_c64 with K[p][j] as the epilogue matrix; then the four wrapper
// products.
//
// What bounds it on an H100: an n = 100 complex product is 8 MFLOP against
// 240 KB of operands, so at the hot path's batch (~10^3 matrices per stage)
// the products are bound by the f32 FMA rate (67 TFLOP/s outside the tensor
// cores, which are not used, so no TF32 rounding enters).  The GEMM's
// design against that bound:
// - a 100 x 50 output tile per 250-thread block, so n = 100 and n = 200
//   tile with no padding (a 32 x 32 tile would spend 39% of its FMAs on
//   padding at n = 100); each thread accumulates 4 x 5 complex outputs,
//   9 shared-memory loads per 20 complex FMAs;
// - 20-deep K slabs staged by cp.async into a double-buffered ring, so the
//   next slab loads while the current one is multiplied;
// - the batch and the tile index share gridDim.x, so any batch fits.
// The chunk pass reads each stored power once and writes each chunk once,
// so a Horner epilogue reads one matrix instead of s - 1 powers.
//
// Layout: row-major interleaved complex64 (float2).  Each operand has its
// own batch stride (in complex elements), so the wrapper can address one
// power or one chunk inside its scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 100;              // output tile rows
constexpr int kTN = 50;               // output tile columns
constexpr int kKD = 20;               // K slab depth
constexpr int kRM = 4;                // complex outputs per thread: rows
constexpr int kRN = 5;                //   and columns
constexpr int kThrN = kTN / kRN;      // 10
constexpr int kThrM = kTM / kRM;      // 25
constexpr int kThreads = kThrM * kThrN;   // 250
constexpr int kMaxChunks = 8;         // Paterson-Stockmeyer chunks per series

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// 8-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// C[b] = A[b] B[b] (+ D[b]) for the tile blockIdx.x % tiles of matrix
// blockIdx.x / tiles.  Thread (ty, tx) owns rows ty + 25 a, columns
// tx + 10 c of the tile.
__global__ void __launch_bounds__(kThreads, 2)
cgemm_kernel(const float2* __restrict__ A, long long sA,
             const float2* __restrict__ B, long long sB,
             const float2* __restrict__ D, long long sD,
             float2* __restrict__ C, long long sC, int n, int tiles_n,
             int tiles) {
  // 48,000 bytes; the rows of 4 threads of a warp that read As at one k
  // fall in distinct banks (row stride 40 words)
  __shared__ __align__(16) float2 As[2][kTM][kKD];   // As[s][i][k]
  __shared__ __align__(16) float2 Bs[2][kKD][kTN];   // Bs[s][k][j]
  const long long b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int row0 = (tile / tiles_n) * kTM;
  const int col0 = (tile % tiles_n) * kTN;
  const int tid = threadIdx.x;
  const int ty = tid / kThrN, tx = tid % kThrN;
  const float2* Ab = A + b * sA;
  const float2* Bb = B + b * sB;

  auto stage = [&](int s, int k0) {
    for (int e = tid; e < kTM * kKD; e += kThreads) {
      const int i = e / kKD, k = e % kKD;
      const int r = row0 + i, c = k0 + k;
      const bool ok = r < n && c < n;
      cp_async8(&As[s][i][k], ok ? Ab + static_cast<long long>(r) * n + c : Ab,
                ok);
    }
    for (int e = tid; e < kKD * kTN; e += kThreads) {
      const int k = e / kTN, j = e % kTN;
      const int r = k0 + k, c = col0 + j;
      const bool ok = r < n && c < n;
      cp_async8(&Bs[s][k][j], ok ? Bb + static_cast<long long>(r) * n + c : Bb,
                ok);
    }
    cp_async_commit();
  };

  const float2 zero = make_float2(0.f, 0.f);
  float2 acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = zero;
  }

  const int nk = (n + kKD - 1) / kKD;
  stage(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      stage((t + 1) & 1, (t + 1) * kKD);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = t & 1;
#pragma unroll
    for (int k = 0; k < kKD; ++k) {
      float2 av[kRM], bv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) av[i] = As[s][ty + kThrM * i][k];
#pragma unroll
      for (int j = 0; j < kRN; ++j) bv[j] = Bs[s][k][tx + kThrN * j];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
#pragma unroll
        for (int j = 0; j < kRN; ++j) cfma(acc[i][j], av[i], bv[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = row0 + ty + kThrM * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int c = col0 + tx + kThrN * j;
      if (c >= n) continue;
      const long long rc = static_cast<long long>(r) * n + c;
      float2 v = acc[i][j];
      if (D != nullptr) {
        const float2 d = D[b * sD + rc];
        v.x += d.x;
        v.y += d.y;
      }
      C[b * sC + rc] = v;
    }
  }
}

// K[b][p][j] = sum_{m < s, j s + m <= terms} coef[b, p, j s + m] P_m[b] for
// the three series p and the R chunks j, one thread per matrix element:
// each stored power P_1 .. P_{s-1} is read once, each chunk written once.
template <int R>
__global__ void ps_chunks_kernel(const float2* __restrict__ pows,
                                 long long sP, int s,
                                 const float* __restrict__ coef,
                                 int coef_stride, int terms,
                                 float2* __restrict__ out, long long sO,
                                 int n, long long total) {
  const long long nn = static_cast<long long>(n) * n;
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (g >= total) return;
  const long long b = g / nn, e = g - b * nn;
  const bool diag = (e / n) == (e % n);
  const float* cb = coef + b * coef_stride;
  float2 acc[3][R];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      // (R - 1) s <= terms, so every chunk's first coefficient exists
      acc[p][j] = make_float2(diag ? cb[p * (terms + 1) + j * s] : 0.f, 0.f);
    }
  }
  for (int m = 1; m < s; ++m) {
    const float2 P = pows[b * sP + (m - 1) * nn + e];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int idx = j * s + m;
        const float c = idx <= terms ? cb[p * (terms + 1) + idx] : 0.f;
        acc[p][j].x = fmaf(c, P.x, acc[p][j].x);
        acc[p][j].y = fmaf(c, P.y, acc[p][j].y);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int j = 0; j < R; ++j) out[b * sO + (p * R + j) * nn + e] = acc[p][j];
  }
}

template <int R>
cudaError_t launch_chunks(const float2* pows, long long sP, int s,
                          const float* coef, int coef_stride, int terms,
                          float2* out, long long sO, int n, long long total,
                          cudaStream_t stream) {
  constexpr int kChunkThreads = 256;
  const long long blocks = (total + kChunkThreads - 1) / kChunkThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ps_chunks_kernel<R><<<static_cast<unsigned>(blocks), kChunkThreads, 0,
                        stream>>>(pows, sP, s, coef, coef_stride, terms, out,
                                  sO, n, total);
  return cudaGetLastError();
}

}  // namespace

// C[b] = A[b] B[b] + D[b] for b < batch, all matrices n x n complex64; D
// may be null (no sum).  C must not alias A, B or D.  Strides are in
// complex elements.  Returns the cudaError_t of the launch.
extern "C" int cgemm_ps_c64(const void* A, long long sA, const void* B,
                            long long sB, const void* D, long long sD,
                            void* C, long long sC, int n, int batch,
                            void* stream) {
  if (n < 1 || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int tiles_n = (n + kTN - 1) / kTN;
  const int tiles = ((n + kTM - 1) / kTM) * tiles_n;
  const long long blocks = static_cast<long long>(tiles) * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cgemm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(A), sA, static_cast<const float2*>(B), sB,
      static_cast<const float2*>(D), sD, static_cast<float2*>(C), sC, n,
      tiles_n, tiles);
  return cudaGetLastError();
}

// out[b, p * r + j] = K[b][p][j] (see ps_chunks_kernel) for b < batch, from
// the stored powers P_m at pows + b sP + (m - 1) n n (1 <= m < s) and the
// float32 coefficient table coef + b coef_stride + p (terms + 1) + k.
// r <= 8.  Strides are in complex elements.  Returns the cudaError_t.
extern "C" int ps_chunks_c64(const void* pows, long long sP, int s,
                             const void* coef, int coef_stride, int terms,
                             int r, void* out, long long sO, int n, int batch,
                             void* stream) {
  if (n < 1 || batch < 0 || s < 1 || r < 1 || r > kMaxChunks
      || (r - 1) * s > terms) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  const long long total = static_cast<long long>(n) * n * batch;
  const auto* p = static_cast<const float2*>(pows);
  const auto* c = static_cast<const float*>(coef);
  auto* o = static_cast<float2*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch_chunks<1>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
    case 2: return launch_chunks<2>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
    case 3: return launch_chunks<3>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
    case 4: return launch_chunks<4>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
    case 5: return launch_chunks<5>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
    case 6: return launch_chunks<6>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
    case 7: return launch_chunks<7>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
    default: return launch_chunks<8>(p, sP, s, c, coef_stride, terms, o, sO, n, total, st);
  }
}
