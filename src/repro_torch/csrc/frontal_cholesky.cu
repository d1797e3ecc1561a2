// Blocked partial Cholesky of frontal matrices, written by hand for Hopper
// (sm_90a).  Plain C entry points, built with the other csrc sources by
// repro_torch/kernels/_build.py and called from
// repro_torch/kernels/frontal_cholesky.py.
//
// Replaces the Pallas TPU kernels of repro/kernels/frontal_cholesky.py:
//   front_factor_kernel  <- front_factor_vmem (:98) / _front_factor_body (:76)
//   panel_factor_kernel  <- panel_factor      (:145) / _panel_factor_body (:120)
//   syrk_kernel          <- syrk_downdate     (:173) / _syrk_body (:163)
//
// Layout: row-major, row i of a front aligned with column i.  Only the lower
// triangle is kept correct, as in the TPU kernels: the factored columns end
// with zeros above the diagonal, and the trailing (Schur) block is updated on
// and below the diagonal only (the host reads tril and symmetrizes).
//
// What bounds it on the card.  On a TPU the whole front lives in VMEM; on an
// H100 a 1024^2 fp32 front (4 MiB) is ~18x a block's 227 KB of shared memory,
// so the front stays in device memory (mostly L2-resident: a front is at most
// 8 MiB of the 50 MB L2).  Work per front is small (a (256,128) front is
// ~6 MFLOP, ~1 MB moved in f64) and the 128 pivot columns of a block depend on
// each other in sequence, so a front is latency-bound, not bound by bytes or
// flops.  The design keeps that sequential part cheap and local:
//   * one CTA per front (grid = batch): a whole factorization is one launch,
//     fronts never share a CTA, so a front's bits do not depend on the batch;
//   * (A) the 128x128 diagonal block is factored column by column in shared
//     memory, so the dependent steps synchronize through shared memory only;
//   * (B) rows below the block are solved against L11 one warp per row, the
//     row held in registers (4 values per lane), multipliers broadcast by
//     warp shuffles: no barrier per column;
//   * (C) the trailing downdate is a shared-memory tiled GEMM (64x64 output
//     tiles, K in chunks of 32, 4x4 accumulators per thread in the working
//     type), lower tiles only.
// No atomics and a fixed summation order everywhere: results are
// deterministic and batch-invariant.  Tensor cores (DMMA / wgmma), TMA and
// more than one CTA per front are later work.
#include <cuda_runtime.h>

namespace {

constexpr int TB = 128;      // pivot block width (TILE on the Python side)
constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr int GT = 64;       // output tile edge of the GEMM downdate
constexpr int KC = 32;       // K chunk of the GEMM downdate
constexpr int DLD = TB + 1;  // padded row stride of the diagonal block
constexpr int GLD = KC + 1;  // padded row stride of a GEMM operand tile

template <typename T>
__device__ __forceinline__ T dev_sqrt(T x);
template <>
__device__ __forceinline__ float dev_sqrt<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double dev_sqrt<double>(double x) { return sqrt(x); }

// out[i, j] = cin[i, j] - sum_k ar[i, k] * ac[j, k] over one GT x GT tile.
// ar / ac point at the tile's first operand row (row stride lda); cin / out
// at the tile's first element (row stride ldc; they may alias).  With
// lower_only, entries with i + diag < j (above the matrix diagonal) are left
// alone.  Called by all NT threads; uses 2*GT*GLD elements of smem.
template <typename T>
__device__ void tile_downdate(const T* ar, const T* ac, int lda, int K,
                              const T* cin, T* out, int ldc, int diag,
                              bool lower_only, T* smem) {
  T* As = smem;
  T* Bs = smem + GT * GLD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int e = threadIdx.x; e < GT * KC; e += NT) {
      const int i = e / KC, kk = e % KC;
      As[i * GLD + kk] = ar[(size_t)i * lda + k0 + kk];
      Bs[i * GLD + kk] = ac[(size_t)i * lda + k0 + kk];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(ty + 16 * i) * GLD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * GLD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (!lower_only || r + diag >= c) {
        const size_t o = (size_t)r * ldc + c;
        out[o] = cin[o] - acc[i][j];
      }
    }
}

// Partial Cholesky, in place, of the leading nfac columns of an (mp x ncols)
// row-major slab (row stride ncols) whose row i aligns with column i.
// Per 128-column block: (A) factor the diagonal block in smem, (B) solve the
// rows below it, (C) downdate the slab's trailing columns [off+TB, ncols).
// Front: ncols = mp, nfac = nbp.  Panel: ncols = nfac = nb.
template <typename T>
__device__ void factor_slab(T* a, int mp, int ncols, int nfac, T* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lda = ncols;
  T* D = smem;

  for (int off = 0; off < nfac; off += TB) {
    // (A) diagonal block: load, factor column by column, store.
    for (int e = tid; e < TB * TB; e += NT) {
      const int r = e / TB, c = e % TB;
      D[r * DLD + c] = a[(size_t)(off + r) * lda + off + c];
    }
    __syncthreads();
    for (int j = 0; j < TB; ++j) {
      const T s = dev_sqrt(D[j * DLD + j]);
      if (tid > j && tid < TB) D[tid * DLD + j] = D[tid * DLD + j] / s;
      __syncthreads();
      if (tid == 0) D[j * DLD + j] = s;
      // rank-1 downdate of the block's remaining lower triangle:
      // D[r, c] -= l[r] * l[c] for j < c <= r < TB
      const int c = j + 1 + (tid & (TB - 1));
      if (c < TB) {
        const T lc = D[c * DLD + j];
        for (int r = c + (tid >> 7); r < TB; r += NT / TB)
          D[r * DLD + c] -= D[r * DLD + j] * lc;
      }
      __syncthreads();
    }
    for (int e = tid; e < TB * TB; e += NT) {
      const int r = e / TB, c = e % TB;
      a[(size_t)(off + r) * lda + off + c] = (r >= c) ? D[r * DLD + c] : T(0);
    }
    for (int e = tid; e < off * TB; e += NT) {  // above the block: zeros
      const int r = e / TB, c = e % TB;
      a[(size_t)r * lda + off + c] = T(0);
    }

    // (B) rows below the block: l_r = a_r L11^-T, one warp per row; lane
    // holds columns lane + 32q, the owner of column j broadcasts l_r[j].
    for (int r = off + TB + warp; r < mp; r += NW) {
      T* row = a + (size_t)r * lda + off;
      T x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = row[lane + 32 * q];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        for (int jl = 0; jl < 32; ++jl) {
          const int j = 32 * q + jl;
          T xj = x[q] / D[j * DLD + j];
          xj = __shfl_sync(0xffffffffu, xj, jl);
          if (lane == jl) x[q] = xj;
#pragma unroll
          for (int p = q; p < 4; ++p) {
            const int k = lane + 32 * p;
            if (k > j) x[p] -= xj * D[k * DLD + j];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) row[lane + 32 * q] = x[q];
    }
    __syncthreads();

    // (C) trailing downdate a[r, c] -= sum_k l[r, k] l[c, k], r >= c.
    const int t0 = off + TB;
    const int nr = (mp - t0) / GT;
    const int nc = (ncols - t0) / GT;
    for (int t = 0; t < nr * nc; ++t) {
      const int ti = t / nc, tj = t % nc;
      if (ti < tj) continue;  // wholly above the diagonal
      const int r0 = t0 + GT * ti, c0 = t0 + GT * tj;
      T* cblk = a + (size_t)r0 * lda + c0;
      tile_downdate<T>(a + (size_t)r0 * lda + off, a + (size_t)c0 * lda + off,
                       lda, TB, cblk, cblk, lda, r0 - c0, true, smem);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) front_factor_kernel(T* a, int mp, int nbp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  factor_slab<T>(a + (size_t)blockIdx.x * mp * mp, mp, mp, nbp, smem);
}

template <typename T>
__global__ void __launch_bounds__(NT) panel_factor_kernel(T* a, int mp, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  factor_slab<T>(a, mp, nb, nb, smem);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    syrk_kernel(const T* c, const T* a, T* out, int m, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int r0 = blockIdx.y * GT, c0 = blockIdx.x * GT;
  const size_t o = (size_t)r0 * m + c0;
  tile_downdate<T>(a + (size_t)r0 * k, a + (size_t)c0 * k, k, k, c + o,
                   out + o, m, 0, false, smem);
}

constexpr size_t factor_smem_elems() {
  return (size_t)TB * DLD > (size_t)2 * GT * GLD ? (size_t)TB * DLD
                                                 : (size_t)2 * GT * GLD;
}

template <typename T>
int launch_front(void* a, int batch, int mp, int nbp, void* stream) {
  const size_t smem = factor_smem_elems() * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      front_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  front_factor_kernel<T><<<batch, NT, smem, (cudaStream_t)stream>>>(
      static_cast<T*>(a), mp, nbp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_panel(void* a, int mp, int nb, void* stream) {
  const size_t smem = factor_smem_elems() * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      panel_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  panel_factor_kernel<T><<<1, NT, smem, (cudaStream_t)stream>>>(
      static_cast<T*>(a), mp, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_syrk(const void* c, const void* a, void* out, int m, int k,
                void* stream) {
  const size_t smem = (size_t)2 * GT * GLD * sizeof(T);
  dim3 grid(m / GT, m / GT);
  syrk_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(a), static_cast<T*>(out),
      m, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int front_factor_f32(void* a, int batch, int mp, int nbp, void* stream) {
  return launch_front<float>(a, batch, mp, nbp, stream);
}
int front_factor_f64(void* a, int batch, int mp, int nbp, void* stream) {
  return launch_front<double>(a, batch, mp, nbp, stream);
}
int panel_factor_f32(void* a, int mp, int nb, void* stream) {
  return launch_panel<float>(a, mp, nb, stream);
}
int panel_factor_f64(void* a, int mp, int nb, void* stream) {
  return launch_panel<double>(a, mp, nb, stream);
}
int syrk_downdate_f32(const void* c, const void* a, void* out, int m, int k,
                      void* stream) {
  return launch_syrk<float>(c, a, out, m, k, stream);
}
int syrk_downdate_f64(const void* c, const void* a, void* out, int m, int k,
                      void* stream) {
  return launch_syrk<double>(c, a, out, m, k, stream);
}
// Message for an error code of any entry point of the library (the
// flash-attention entry points included).
const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
