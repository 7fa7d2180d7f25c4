// Batched explicit inverse of complex64 matrices by unpivoted, blocked
// Gauss-Jordan elimination.
//
// Replaces: metalens_tpu/solver/pallas_inv.py::_inv_kernel (the TPU kernel
// behind cpx.solve), which inverts G matrices per grid step by 2x2 block
// recursion down to an unpivoted Gauss-Jordan base.  The recursion is
// algebraically that same elimination, so this kernel runs the elimination
// directly, with the same unpivoted contract: the caller guarantees
// well-conditioned leading blocks (the lossy EPS_REF doubling basis and the
// Hermitian positive-definite eps Toeplitz matrices of the RCWA hot path).
//
// What bounds it on an H100: 8 n^3 flops per matrix (n rank-1 updates of the
// whole n x n working copy) against 16 n^2 bytes of device traffic, so the
// roofline bound is the f32 FMA rate.  A plain elimination never gets near
// it: each pivot is a pass over the working copy with a barrier between
// passes, so the bandwidth of the memory that holds the copy and barrier
// latency set the pace.  Both routes below eliminate in panels of KB = 8
// pivots (blocked Gauss-Jordan).  Every warp inverts the KB x KB pivot
// block P in registers (shuffles, no barrier) and computes its share of the
// eliminated pivot rows Rw = P^-1 A[P, :]; then every other entry takes one
// rank-KB update, w -= A[:, P] Rw, from a register tile of R x C entries and
// R + C panel values per pivot.  The threads that own the next panel's rows
// and columns publish them as they finish the update, so a panel costs two
// block barriers instead of two per pivot.
//
// - n <= 128 (one block per matrix): the working copy lives in registers
//   for the whole elimination, cyclically distributed -- thread (ty, tx)
//   owns rows ty + TDY a and columns tx + TDX c (at n = 100, 15 x 17
//   threads of 7 x 6 complex, within 128 registers so that two blocks share
//   an SM and one's barriers hide behind the other's FMAs).  Only the
//   panel's pivot rows and columns and Rw pass through shared memory, and
//   device memory sees one read of A and one write of A^-1.
// - 128 < n <= 256 (a thread-block cluster per matrix): the working copy
//   (320 KB at n = 200) exceeds a block's 227 KB of shared memory, so it is
//   split by column panels across a cluster of CL blocks on neighbouring SMs
//   (CL = 2 to n = 200, 4 above), each holding its n x NL slab in shared
//   memory.  Per panel the block that owns the pivot columns exports the
//   n x KB column panel; the others copy it through distributed shared
//   memory after one cluster barrier.  Device memory again sees one read of
//   A and one write of A^-1.
//
// Layout: row-major (batch, n, n) interleaved complex64 (float2), as torch
// stores complex64.  Plain f32 FMAs, no tensor cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KB = 8;                 // pivots per panel: 4 lanes per row
constexpr int kRegThreads = 256;      // register route: TDX TDY <= 256
constexpr int kClusterTX = 16;        // cluster route: 16 x 32 threads
constexpr int kClusterTY = 32;
constexpr int kClusterThreads = kClusterTX * kClusterTY;
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(KB * 4 == 32, "one warp holds the pivot block, 4 lanes a row");

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc += a b
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// acc -= a b
__device__ __forceinline__ void cfms(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(-a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(-a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

// The eliminated pivot rows of one panel, by each full warp for its share
// of the columns.  Lane 4 m + q holds row m of the pivot block
// P[m][j] = pp[m * pr_stride + j * pc_stride] (m, j < kb; identity on pad
// pivots) and inverts it in registers by unpivoted Gauss-Jordan -- step k:
// r = P[k, :] / P[k][k] (r[k] = 1 / P[k][k]), row k becomes r, row m != k
// becomes (j == k ? 0 : P[m][j]) - P[m][k] r[j].  Then
// rw[m][j] = sum_j' P^-1[m][j'] rowp[j'][j] for the row panel rowp, except
// in the pivot columns j = piv + j' (j' < KB), where rw[m][j] = P^-1[m][j'].
// Columns j = warp + nwarps (q + 4 t) < width; row stride ld.
__device__ void panel_rows(const float2* __restrict__ pp, int pr_stride,
                           int pc_stride, int kb,
                           const float2* __restrict__ rowp,
                           float2* __restrict__ rw, int ld, int width,
                           int piv, int warp, int nwarps, int lane) {
  const int m = lane >> 2, q = lane & 3;
  float2 pr[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    pr[j] = (m < kb && j < kb) ? pp[m * pr_stride + j * pc_stride]
                               : make_float2(m == j ? 1.f : 0.f, 0.f);
  }
  // one pivot-row entry at a time (few live registers: the caller's tile
  // stays in registers meanwhile); each entry is read from lane 4 k before
  // that lane overwrites it
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float px = __shfl_sync(kFullWarp, pr[k].x, 4 * k);
    const float py = __shfl_sync(kFullWarp, pr[k].y, 4 * k);
    const float d = px * px + py * py;
    const float2 inv = make_float2(px / d, -py / d);
    const float2 c = pr[k];
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float2 r;
      r.x = __shfl_sync(kFullWarp, pr[j].x, 4 * k);
      r.y = __shfl_sync(kFullWarp, pr[j].y, 4 * k);
      r = (j == k) ? inv : cmul(r, inv);
      float2 v = (j == k) ? make_float2(0.f, 0.f) : pr[j];
      cfms(v, c, r);
      pr[j] = (m == k) ? r : v;
    }
  }
  for (int j = warp + nwarps * q; j < width; j += 4 * nwarps) {
    const int jm = j - piv;
    float2 v = make_float2(0.f, 0.f);
    if (jm >= 0 && jm < KB) {
#pragma unroll
      for (int jj = 0; jj < KB; ++jj) {
        if (jj == jm) v = pr[jj];
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < KB; ++jj) cfma(v, pr[jj], rowp[jj * ld + j]);
    }
    rw[m * ld + j] = v;
  }
}

// ---- n <= 128: one block of TDX x TDY threads per matrix, registers ----
//
// Thread (ty, tx) owns rows ty + TDY i (i < TR) and columns tx + TDX j
// (j < TC).  Shared memory, with NR = TDY TR rows and NC = TDX TC columns
// covered: rowp [KB][NC] the panel's pivot rows, colp 2 x [KB][NR] its
// pivot columns (transposed; the next panel's are published while this
// one's are read), rw [KB][NC].
template <int TR, int TC, int MINB>
__global__ void __launch_bounds__(kRegThreads, MINB)
cinv_reg_kernel(const float2* __restrict__ a, float2* __restrict__ out, int n) {
  extern __shared__ float2 smem[];
  const int TDX = blockDim.x, TDY = blockDim.y;
  const int NR = TDY * TR, NC = TDX * TC;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TDX + tx;
  const int nthr = TDX * TDY;
  const int warp = tid >> 5, nwarps = nthr >> 5;   // full warps only
  float2* rowp = smem;
  float2* colp0 = rowp + KB * NC;
  float2* rw = colp0 + 2 * KB * NR;
  const float2 zero = make_float2(0.f, 0.f);
  const size_t nn = static_cast<size_t>(n) * n;
  const float2* src = a + blockIdx.x * nn;
  float2* dst = out + blockIdx.x * nn;

  float2 w[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int row = ty + TDY * i, col = tx + TDX * j;
      w[i][j] = (row < n && col < n) ? src[static_cast<size_t>(row) * n + col]
                                     : zero;
    }
  }

  // the owners write panel k0's pivot rows and columns; pad pivots are 0
  auto publish = [&](int k0, float2* colp) {
    const int kb = min(KB, n - k0);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int m = ty + TDY * i - k0;
      if (m >= 0 && m < kb) {
#pragma unroll
        for (int j = 0; j < TC; ++j) rowp[m * NC + tx + TDX * j] = w[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int m = tx + TDX * j - k0;
      if (m >= 0 && m < kb) {
#pragma unroll
        for (int i = 0; i < TR; ++i) colp[m * NR + ty + TDY * i] = w[i][j];
      }
    }
    for (int e = tid; e < (KB - kb) * NC; e += nthr) rowp[kb * NC + e] = zero;
    for (int e = tid; e < (KB - kb) * NR; e += nthr) colp[kb * NR + e] = zero;
  };

  publish(0, colp0);
  for (int k0 = 0, it = 0; k0 < n; k0 += KB, ++it) {
    const int kb = min(KB, n - k0);
    const float2* colp = colp0 + (it & 1) * KB * NR;
    __syncthreads();
    if (warp < nwarps) {
      panel_rows(rowp + k0, NC, 1, kb, rowp, rw, NC, NC, k0, warp, nwarps,
                 tid & 31);
    }
    __syncthreads();
    // rank-KB update of the register tile: pivot columns start from 0,
    // pivot rows become Rw
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int m = tx + TDX * j - k0;
      if (m >= 0 && m < kb) {
#pragma unroll
        for (int i = 0; i < TR; ++i) w[i][j] = zero;
      }
    }
#pragma unroll
    for (int m = 0; m < KB; ++m) {
      float2 cm[TR], rm[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) cm[i] = colp[m * NR + ty + TDY * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) rm[j] = rw[m * NC + tx + TDX * j];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < TC; ++j) cfms(w[i][j], cm[i], rm[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int m = ty + TDY * i - k0;
      if (m >= 0 && m < kb) {
#pragma unroll
        for (int j = 0; j < TC; ++j) w[i][j] = rw[m * NC + tx + TDX * j];
      }
    }
    if (k0 + KB < n) publish(k0 + KB, colp0 + ((it + 1) & 1) * KB * NR);
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int row = ty + TDY * i, col = tx + TDX * j;
      if (row < n && col < n) dst[static_cast<size_t>(row) * n + col] = w[i][j];
    }
  }
}

// ---- 128 < n <= 256: a cluster of CL blocks per matrix ------------------
//
// Column panel p (pivots p KB .. p KB + KB - 1) lives in block p % CL at
// local columns (p / CL) KB ..; each block holds all n rows of its NL local
// columns in shared memory (Ws, row-major n x NL).  Thread (ty, tx) of the
// 32 x 16 block updates rows ty + 32 a (a < R) and local columns tx + 16 c
// (c < C), RG rows at a time from registers.
__host__ __device__ constexpr int cluster_local_cols(int n, int cl) {
  return ((n + KB - 1) / KB + cl - 1) / cl * KB;
}

__host__ __device__ constexpr size_t cluster_smem_elems(int n, int cl) {
  // Ws, the exported column panel and its local copy, rowp, rw
  return static_cast<size_t>(n) * cluster_local_cols(n, cl)
         + 2 * static_cast<size_t>(KB) * n
         + 2 * static_cast<size_t>(KB) * cluster_local_cols(n, cl);
}

template <int CL, int R, int C>
__global__ void __launch_bounds__(kClusterThreads, 1)
cinv_cluster_kernel(const float2* __restrict__ a, float2* __restrict__ out,
                    int n) {
  constexpr int RG = 4;   // rows per register group
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int NL = cluster_local_cols(n, CL);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kClusterTX + tx;
  float2* Ws = smem;
  float2* exp_colp = Ws + static_cast<size_t>(n) * NL;   // [KB][n]
  float2* colp = exp_colp + KB * n;                      // [KB][n]
  float2* rowp = colp + KB * n;                          // [KB][NL]
  float2* rw = rowp + KB * NL;                           // [KB][NL]
  const float2 zero = make_float2(0.f, 0.f);
  const size_t mat = blockIdx.x / CL;
  const size_t nn = static_cast<size_t>(n) * n;
  const float2* src = a + mat * nn;
  float2* dst = out + mat * nn;
  auto gcol = [&](int jl) { return ((jl / KB) * CL + rank) * KB + jl % KB; };
  const int npan = (n + KB - 1) / KB;

  for (int e = tid; e < n * NL; e += kClusterThreads) {
    const int i = e / NL, g = gcol(e % NL);
    Ws[e] = g < n ? src[static_cast<size_t>(i) * n + g] : zero;
  }
  __syncthreads();
  // panel 0: its pivot rows of the local columns, and its column panel
  // from the owner; pad pivots are 0
  for (int e = tid; e < KB * NL; e += kClusterThreads) {
    const int m = e / NL;
    rowp[e] = m < min(KB, n) ? Ws[m * NL + e % NL] : zero;
  }
  if (rank == 0) {
    for (int e = tid; e < KB * n; e += kClusterThreads) {
      const int m = e / n;
      exp_colp[e] = m < min(KB, n) ? Ws[(e % n) * NL + m] : zero;
    }
  }

  for (int p = 0; p < npan; ++p) {
    const int k0 = p * KB, kb = min(KB, n - k0);
    const int owner = p % CL, lo = (p / CL) * KB;
    const int pn = p + 1, k0n = pn * KB, kbn = min(KB, n - k0n);
    const bool exports_next = pn < npan && rank == pn % CL;
    const int lon = (pn / CL) * KB;
    cluster.sync();
    const float2* rcol = cluster.map_shared_rank(exp_colp, owner);
    for (int e = tid; e < KB * n; e += kClusterThreads) colp[e] = rcol[e];
    __syncthreads();
    // P[m][j] = A[k0 + m][k0 + j] = colp[j][k0 + m]
    panel_rows(colp + k0, 1, n, kb, rowp, rw, NL, NL,
               rank == owner ? lo : -2 * KB, tid >> 5,
               kClusterThreads / 32, tid & 31);
    __syncthreads();
    // pad pivots of the next panel
    if (pn < npan) {
      for (int e = tid; e < (KB - kbn) * NL; e += kClusterThreads) {
        rowp[kbn * NL + e] = zero;
      }
      if (exports_next) {
        for (int e = tid; e < (KB - kbn) * n; e += kClusterThreads) {
          exp_colp[kbn * n + e] = zero;
        }
      }
    }
#pragma unroll
    for (int a0 = 0; a0 < R; a0 += RG) {
      float2 w[RG][C];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const int row = ty + kClusterTY * (a0 + i);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int jl = tx + kClusterTX * j;
          const bool pivot_col = rank == owner && jl - lo >= 0 && jl - lo < kb;
          w[i][j] = (a0 + i < R && row < n && jl < NL && !pivot_col)
              ? Ws[row * NL + jl] : zero;
        }
      }
#pragma unroll
      for (int m = 0; m < KB; ++m) {
        float2 cm[RG], rm[C];
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const int row = ty + kClusterTY * (a0 + i);
          cm[i] = row < n ? colp[m * n + row] : zero;
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int jl = tx + kClusterTX * j;
          rm[j] = jl < NL ? rw[m * NL + jl] : zero;
        }
#pragma unroll
        for (int i = 0; i < RG; ++i) {
#pragma unroll
          for (int j = 0; j < C; ++j) cfms(w[i][j], cm[i], rm[j]);
        }
      }
      // store, and publish the next panel's pivot rows and columns
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const int row = ty + kClusterTY * (a0 + i);
        if (a0 + i >= R || row >= n) continue;
        const int m = row - k0, mn = row - k0n;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int jl = tx + kClusterTX * j;
          if (jl >= NL) continue;
          const float2 v = (m >= 0 && m < kb) ? rw[m * NL + jl] : w[i][j];
          Ws[row * NL + jl] = v;
          if (pn < npan && mn >= 0 && mn < kbn) rowp[mn * NL + jl] = v;
          if (exports_next && jl - lon >= 0 && jl - lon < kbn) {
            exp_colp[(jl - lon) * n + row] = v;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < n * NL; e += kClusterThreads) {
    const int i = e / NL, g = gcol(e % NL);
    if (g < n) dst[static_cast<size_t>(i) * n + g] = Ws[e];
  }
  // no block may leave while another can still read its exported panel
  cluster.sync();
}

template <int TR, int TC, int MINB>
cudaError_t launch_reg(const float2* a, float2* out, int n, int batch,
                       cudaStream_t s) {
  // at least one full warp: warps invert the pivot block
  const int tdx = max((n + TC - 1) / TC, 6), tdy = max((n + TR - 1) / TR, 6);
  if (tdx * tdy > kRegThreads) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(KB) * (2 * tdx * TC + 2 * tdy * TR)
                      * sizeof(float2);
  auto kernel = cinv_reg_kernel<TR, TC, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, dim3(tdx, tdy), smem, s>>>(a, out, n);
  return cudaGetLastError();
}

template <int CL, int R, int C>
cudaError_t launch_cluster(const float2* a, float2* out, int n, int batch,
                           cudaStream_t s) {
  if (cluster_local_cols(n, CL) > kClusterTX * C || n > kClusterTY * R) {
    return cudaErrorInvalidValue;
  }
  auto kernel = cinv_cluster_kernel<CL, R, C>;
  const size_t smem = cluster_smem_elems(n, CL) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * CL);
  cfg.blockDim = dim3(kClusterTX, kClusterTY);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, out, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// out[b] = inverse(a[b]) for b < batch; a and out are distinct device
// buffers of batch * n * n complex64, 1 <= n <= 256.  Routes: registers for
// n <= 128, a 2-block cluster for n <= 200, a 4-block cluster above.
// Returns the cudaError_t of the launch.
extern "C" int cinv_c64(const void* a, void* out, int n, int batch,
                        void* stream) {
  if (n < 1 || n > 256 || batch < 0 || batch > (1 << 28)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* pa = static_cast<const float2*>(a);
  float2* po = static_cast<float2*>(out);
  if (n <= 64) return launch_reg<4, 4, 1>(pa, po, n, batch, s);
  // n = 100: 15 x 17 threads of 7 x 6 complex, two blocks per SM
  if (n <= 102) return launch_reg<7, 6, 2>(pa, po, n, batch, s);
  if (n <= 128) return launch_reg<8, 8, 1>(pa, po, n, batch, s);
  if (n <= 200) return launch_cluster<2, 7, 7>(pa, po, n, batch, s);
  return launch_cluster<4, 8, 4>(pa, po, n, batch, s);
}
