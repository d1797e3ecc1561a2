// Blocked partial Cholesky of frontal matrices, written by hand for Hopper
// (sm_90a).  Plain C entry points, built with the other csrc sources by
// repro_torch/kernels/_build.py and called from
// repro_torch/kernels/frontal_cholesky.py.
//
// Replaces the Pallas TPU kernels of repro/kernels/frontal_cholesky.py:
//   front_factor_kernel  <- front_factor_vmem (:98) / _front_factor_body (:76)
//   panel_factor_kernel  <- panel_factor      (:145) / _panel_factor_body (:120)
//   syrk_kernel          <- syrk_downdate     (:173) / _syrk_body (:163)
//   extend_add_kernel    <- none (the TPU executor extend-adds on the host)
//
// Layout: row-major, row i of a front aligned with column i.  Only the lower
// triangle is kept correct, as in the TPU kernels: the factored columns end
// with zeros above the diagonal, and the trailing (Schur) block is updated on
// and below the diagonal only (the host reads tril and symmetrizes).
//
// What bounds it on the card.  On a TPU the whole front lives in VMEM; on an
// H100 a 1024^2 f64 front (8 MiB) is ~36x a block's 227 KB of shared memory,
// so the front stays in device memory (L2-resident: at most 8 MiB of the
// 50 MB L2).  Work per front is small (a (256,128) front is ~6 MFLOP) and the
// 128 pivots of a block depend on each other in sequence, so a front is
// bound by latency (dependent steps and barriers), not by bytes or flops.
// front_factor and panel_factor share one routine, factor_slab:
//   * one thread-block cluster per front (panel_factor: one cluster for the
//     slab).  Its size (cluster_size: 2 CTAs for a 256-row front, 16 from
//     768 rows), and which rows and tiles each CTA takes, depend on the
//     slab's shape only, never on the batch, so a front's bits do not depend
//     on the batch it rides in;
//   * (A) every CTA of the cluster factors the same 128x128 diagonal block
//     in its own shared memory with the same code (identical bits, no
//     distributed shared memory): right-looking by 32-column sub-blocks, a
//     32-step factor of the sub-block by one warp in registers (shuffles,
//     one reciprocal square root per pivot), a row-parallel solve of the
//     rows below it and one product downdating the rest of the block;
//   * (B) rows below the block are split over the cluster's CTAs and staged
//     in shared memory 64 at a time; per 32-column sub-block, one product
//     with the sub-blocks already solved, then a solve against L_ss, one
//     row per thread, pivots applied as reciprocals;
//   * (C) the trailing downdate's lower 64x64 output tiles are dealt to the
//     CTAs round-robin and stream through a ring of three shared-memory
//     stages filled by cp.async (16 bytes) two K chunks ahead, across tile
//     boundaries;
//   * products run on the FP64 tensor cores in f64 (mma.sync m16n8k8 in
//     (C), m8n8k4 in (A) and (B)) and on FFMA in f32 (wgmma has no f64 form
//     and TF32 would miss the reference's tolerance);
//   * barrier.cluster (cluster.sync) separates (B) from (C) and (C) from the
//     next block; data written by other CTAs is read with ld.global.cg /
//     cp.async.cg (through L2, never a stale L1 line).
// What bounds it now (repro_torch.kernels.frontal_split times each phase):
// the pivot chain of (A), repeated by every CTA, for the small fronts of
// the main path; the (C) tiles of the largest fronts, which keep 16 of the
// 132 SMs busy per front; then the row solves of (B).  No atomics and a fixed summation order everywhere: results are
// deterministic and batch-invariant.
//
// syrk_kernel computes C - A A^T over the lower 64x64 tiles with the same
// (C) machinery (lower_downdate: cp.async ring, DMMA in f64, FFMA in f32;
// TF32 would miss the reference's tolerance), one CTA per tile: half the
// flops of the full product, the same bytes.  Two forms:
//   * uplo='L' (BLAS syrk, what the large-front route reads): CTAs of their
//     own copy the strictly-upper tiles of C through;
//   * full (the reference's result): A A^T is symmetric, so the CTA of a
//     lower tile (i, j) also writes the upper tile (j, i) as C(j, i) less
//     the transpose of the product it holds, and a diagonal tile writes its
//     entries above the diagonal from the full 64x64 product it computes.
//
// extend_add_kernel adds a child's Schur block into its parent's front, for
// the large-front route, which assembles its fronts on the card in float64
// as the host does: it reads the block's lower triangle (straight from the
// child's factored padded front, or from an uploaded block), upcasts it,
// and adds entry (i, j), j <= i, at (pos[i], pos[j]) and, off the diagonal,
// at (pos[j], pos[i]).  pos is strictly increasing, so every entry of the
// parent is read and written by one thread at most: no atomics, the host's
// sums bit for bit.  Bound by bytes (a 3,794^2 f64 block: ~115 MB of reads
// and read-modify-writes, ~35 us at 3.35 TB/s).  A CTA of 32 x 8 threads
// takes a 32 x 32 tile of the lower triangle through shared memory, so the
// reads and both writes run along rows (the mirror's rows are the tile's
// columns); tiles above the diagonal exit at once.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int TB = 128;      // pivot block width (TILE on the Python side)
constexpr int SB = 32;       // sub-block width inside a pivot block
constexpr int NT = 256;      // threads per CTA
constexpr int GT = 64;       // output tile edge of the GEMM downdates
constexpr int DLD = TB + 1;  // padded row stride of the diagonal block
constexpr int MAX_CLUSTER = 16;  // the H100 holds clusters of 16 (non-portable)

// 1/sqrt(x): one hardware estimate and its refinement (within an ulp or
// two), instead of a rounded square root followed by a division.
template <typename T>
__device__ __forceinline__ T dev_rsqrt(T x);
template <>
__device__ __forceinline__ float dev_rsqrt<float>(float x) { return rsqrtf(x); }
template <>
__device__ __forceinline__ double dev_rsqrt<double>(double x) { return rsqrt(x); }

// Load through L2 (never L1): the value may have been written by another
// CTA of the cluster before the last cluster barrier.
template <typename T>
__device__ __forceinline__ T ldcg(const T* p) { return __ldcg(p); }

// 16 bytes from gmem into smem, or 16 zero bytes when !in (nothing read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b on the FP64 tensor cores: one 8x8x4 product per warp.  A is
// 8x4 row-major (lane holds A[lane/4][lane%4]), B is 4x8 column-major
// (lane holds B[lane%4][lane/4]), D 8x8 (lane holds D[lane/4][2*(lane%4)+i]).
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// ----------------------------------------------------------------------
// (C) the trailing downdate: out[i, j] -= sum_k ar[i, k] ac[j, k] over
// K = TB for each of a CTA's 64x64 output tiles, operands and output in
// device memory (row stride lda).  The CTA's (tile, 64-wide K chunk) pairs
// form one stream through a ring of NS shared-memory stages, filled by
// cp.async NS-1 chunks ahead, across tile boundaries.
// ----------------------------------------------------------------------
constexpr int CK = 64;                 // K chunk of a stage
constexpr int CLD = CK + 4;            // row stride of a stage's operand tile (16-B rows)
constexpr int NS = 3;                  // ring stages
constexpr int STAGE = 2 * GT * CLD;    // elements per stage (both operands)

// d += a * b on the FP64 tensor cores, one 16x8x8 product per warp (g =
// lane/4, t = lane%4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4], const double (&a)[4], double b0,
                                            double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// The t-th lower 64x64 tile, in row-major order, of a grid of nr x nc.
__device__ __forceinline__ void lower_tile(int t, int nc, int& ti, int& tj) {
  ti = 0;
  while (t >= min(ti + 1, nc)) t -= min(++ti, nc);
  tj = t;
}

// C - A A^T over the lower 64x64 tiles of an output of nr x nc tiles: tile
// (ti, tj), ti >= tj, of out gets cin's tile less the product of rows
// 64 ti + [0, 64) and 64 tj + [0, 64) of the operand op (row stride lda,
// K columns; out and cin row stride ldc).  On a diagonal tile only entries
// on or below the diagonal are downdated; those above it are left alone
// (out == cin) or copied from cin.  The CTA's tiles are t = rank + u * cs in
// row-major order over the lower triangle; its (tile, K chunk) pairs form
// one stream through a ring of NS shared-memory stages of CKT-wide K
// chunks, filled by cp.async NS-1 chunks ahead, across tile boundaries.  A
// thread reads its 16 entries of cin for the first tile while the first
// chunks load, and for each later tile when its first chunk is in hand, so
// that load is under the tile's products.  K is a multiple of 16 bytes'
// worth of elements; a last partial chunk is zero-filled.  MIRROR (out !=
// cin): every entry of a diagonal tile is downdated, and an off-diagonal
// tile (ti, tj) also writes tile (tj, ti) of out as cin's (tj, ti) less the
// transposed product.
template <typename T, int CKT = CK, bool MIRROR = false>
__device__ void lower_downdate(const T* op, int lda, int K, const T* cin, T* out, int ldc,
                               int nr, int nc, int rank, int cs, T* smem) {
  constexpr int LDT = CKT + 4;       // row stride of a stage's operand tile
  constexpr int STG = 2 * GT * LDT;  // elements per stage
  int nlow = 0;
  for (int ti = 0; ti < nr; ++ti) nlow += min(ti + 1, nc);
  const int nch = (K + CKT - 1) / CKT;                      // K chunks per tile
  const int mine = rank < nlow ? (nlow - rank + cs - 1) / cs : 0;  // tiles t = rank + u*cs
  const int nq = mine * nch;
  const int tid = threadIdx.x;
  const bool copy = out != cin;

  auto fetch = [&](int q) {  // chunk q of the stream into stage q % NS
    if (q < nq) {
      int ti, tj;
      lower_tile(rank + (q / nch) * cs, nc, ti, tj);
      const int k0 = (q % nch) * CKT;
      const T* ar = op + (size_t)(GT * ti) * lda + k0;
      const T* ac = op + (size_t)(GT * tj) * lda + k0;
      T* As = smem + (q % NS) * STG;
      T* Bs = As + GT * LDT;
      constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
      constexpr int PER_ROW = CKT / V;
      for (int e = tid; e < GT * PER_ROW; e += NT) {
        const int i = e / PER_ROW, kk = (e % PER_ROW) * V;
        const bool in = k0 + kk < K;
        cp_async16(As + i * LDT + kk, ar + (size_t)i * lda + (in ? kk : 0), in);
        cp_async16(Bs + i * LDT + kk, ac + (size_t)i * lda + (in ? kk : 0), in);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // entry u of the thread's 16 in tile (ti, tj): rc(u) gives (r, c); a
  // diagonal tile's entries above the diagonal are kept (or copied) from cin
  auto offset = [&](int ti, int tj, int r, int c) {
    return (size_t)(GT * ti + r) * ldc + GT * tj + c;
  };
  auto load_tile = [&](int ti, int tj, auto rc, T (&cv)[16]) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      int r, c;
      rc(u, r, c);
      cv[u] = (MIRROR || ti != tj || r >= c || copy) ? ldcg(cin + offset(ti, tj, r, c)) : T(0);
    }
  };
  auto write_tile = [&](int ti, int tj, auto rc, const T (&cv)[16], T (&acc)[16]) {
    if constexpr (MIRROR) {
      if (ti != tj) {  // tile (tj, ti): cin's entries less the transposed product
        T mv[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          int r, c;
          rc(u, r, c);
          mv[u] = ldcg(cin + offset(tj, ti, c, r));
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          int r, c;
          rc(u, r, c);
          out[offset(tj, ti, c, r)] = mv[u] - acc[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      int r, c;
      rc(u, r, c);
      if (MIRROR || ti != tj || r >= c)
        out[offset(ti, tj, r, c)] = cv[u] - acc[u];
      else if (copy)
        out[offset(ti, tj, r, c)] = cv[u];
      acc[u] = T(0);
    }
  };

  for (int q = 0; q < NS - 1; ++q) fetch(q);
  T acc[16] = {};
  T cv[16];
  int ti = 0, tj = 0;
  if constexpr (std::is_same<T, double>::value) {
    // 8 warps: warp w owns rows 16*(w/2) + [0, 16), cols 32*(w%2) + [0, 32):
    // four 16x8 DMMA tiles, acc[4j + h] = D_j[g + 8(h/2)][2 t4 + (h%2)].
    const int lane = tid & 31, warp = tid >> 5;
    const int wr = 16 * (warp >> 1), wc = 32 * (warp & 1);
    const int g = lane >> 2, t4 = lane & 3;
    auto rc = [&](int u, int& r, int& c) {
      r = wr + g + 8 * ((u & 3) >> 1);
      c = wc + 8 * (u >> 2) + 2 * t4 + (u & 1);
    };
    if (nq) {  // the first tile's cin entries, while its first chunks load
      lower_tile(rank, nc, ti, tj);
      load_tile(ti, tj, rc, cv);
    }
    for (int q = 0; q < nq; ++q) {
      fetch(q + NS - 1);
      cp_async_wait<NS - 1>();
      __syncthreads();
      if (q % nch == 0 && q) {  // a new tile: its cin entries, under the products
        lower_tile(rank + (q / nch) * cs, nc, ti, tj);
        load_tile(ti, tj, rc, cv);
      }
      const double* As = smem + (q % NS) * STG;
      const double* Bs = As + GT * LDT;
#pragma unroll
      for (int k = 0; k < CKT; k += 8) {
        const double* ap = As + (wr + g) * LDT + k + t4;
        const double av[4] = {ap[0], ap[8 * LDT], ap[4], ap[8 * LDT + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double* bp = Bs + (wc + 8 * j + g) * LDT + k + t4;
          dmma_16x8x8(*reinterpret_cast<double(*)[4]>(acc + 4 * j), av, bp[0], bp[4]);
        }
      }
      if (q % nch == nch - 1) write_tile(ti, tj, rc, cv, acc);  // the tile's last chunk
      __syncthreads();  // stage q % NS is refilled next
    }
  } else {
    // f32: 16x16 threads, each a 4x4 FFMA tile (rows ty + 16i, cols tx + 16j),
    // acc[4i + j].
    const int tx = tid & 15, ty = tid >> 4;
    auto rc = [&](int u, int& r, int& c) {
      r = ty + 16 * (u >> 2);
      c = tx + 16 * (u & 3);
    };
    if (nq) {
      lower_tile(rank, nc, ti, tj);
      load_tile(ti, tj, rc, cv);
    }
    for (int q = 0; q < nq; ++q) {
      fetch(q + NS - 1);
      cp_async_wait<NS - 1>();
      __syncthreads();
      if (q % nch == 0 && q) {
        lower_tile(rank + (q / nch) * cs, nc, ti, tj);
        load_tile(ti, tj, rc, cv);
      }
      const float* As = smem + (q % NS) * STG;
      const float* Bs = As + GT * LDT;
      // four k at a time by 16-byte reads (a quarter warp's eight rows
      // then fall on distinct banks), summed in k order
#pragma unroll 2
      for (int kk = 0; kk < CKT; kk += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDT + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * LDT + kk);
        const float* a4 = reinterpret_cast<const float*>(av);
        const float* b4 = reinterpret_cast<const float*>(bv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[4 * i + j] = fmaf(a4[4 * i + u], b4[4 * j + u], acc[4 * i + j]);
      }
      if (q % nch == nch - 1) write_tile(ti, tj, rc, cv, acc);
      __syncthreads();
    }
  }
  cp_async_wait<0>();
}

// (C) the trailing downdate of factor_slab, in place: out[i, j] -= sum_k
// ar[i, k] ac[j, k] over K = TB (the block's columns from off) for the
// lower 64x64 tiles of the trailing block from row and column t0.
template <typename T>
__device__ void trailing_downdate(T* a, int lda, int off, int t0, int nr, int nc, int rank,
                                  int cs, T* smem) {
  T* c = a + (size_t)t0 * lda + t0;
  lower_downdate<T>(a + (size_t)t0 * lda + off, lda, TB, c, c, lda, nr, nc, rank, cs, smem);
}

// ----------------------------------------------------------------------
// (A) and (B): the diagonal block and the rows below it, in shared memory
// ----------------------------------------------------------------------
// C -= A B^T on shared-memory operands, by 8x8 output tiles dealt to the
// warps, each warp four tiles at a time (four independent accumulators):
// C is (8*m8 x 8*n8), A (8*m8 x K), B (8*n8 x K), K a multiple of 4, row
// strides ldc / lda / ldb.  With lower (m8 == n8), only the tiles on or
// below the diagonal are computed and only entries on or below it written.
// f64 on DMMA; f32 on FFMA, each lane the two entries a DMMA lane holds.
template <typename T>
__device__ void smem_update(T* C, int ldc, const T* A, int lda, const T* B, int ldb, int m8,
                            int n8, int K, bool lower) {
  constexpr int NWARP = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntiles = lower ? m8 * (m8 + 1) / 2 : m8 * n8;
  for (int p0 = warp; p0 < ntiles; p0 += 4 * NWARP) {
    int ti[4], tj[4];
    bool on[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // tile p: row-major over the lower triangle or the grid
      const int p = p0 + u * NWARP;
      on[u] = p < ntiles;
      if (lower) {
        int i = (int)((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
        while (i * (i + 1) / 2 > p) --i;
        while ((i + 1) * (i + 2) / 2 <= p) ++i;
        ti[u] = i;
        tj[u] = p - i * (i + 1) / 2;
      } else {
        ti[u] = p / n8;
        tj[u] = p % n8;
      }
    }
    T acc[4][2] = {};
    for (int k = 0; k < K; k += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!on[u]) continue;
        const T* ar = A + (8 * ti[u] + g) * lda + k;
        if constexpr (std::is_same<T, double>::value) {
          dmma_8x8x4(acc[u][0], acc[u][1], ar[t4], B[(8 * tj[u] + g) * ldb + k + t4]);
        } else {
          const T* b0 = B + (8 * tj[u] + 2 * t4) * ldb + k;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[u][0] = fmaf(ar[kk], b0[kk], acc[u][0]);
            acc[u][1] = fmaf(ar[kk], b0[ldb + kk], acc[u][1]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!on[u]) continue;
      const int r = 8 * ti[u] + g, c = 8 * tj[u] + 2 * t4;
      const bool diag = lower && ti[u] == tj[u];
      T* o = C + r * ldc + c;
      if (!diag || r >= c) o[0] -= acc[u][0];
      if (!diag || r >= c + 1) o[1] -= acc[u][1];
    }
  }
}

constexpr int XR = 64;       // rows of a (B) chunk
constexpr int XLD = TB + 4;  // row stride of the (B) chunk

// x := x L_ss^-T for one row x of 32 entries (columns sb + [0, 32)), where
// L_ss is the factored 32x32 diagonal sub-block at (sb, sb) of D and rinv
// holds the reciprocals of its pivots.  32 dependent steps, each one
// multiply and the FMAs of the entries after it.
template <typename T>
__device__ __forceinline__ void solve_sub(T (&x)[SB], const T* D, const T* rinv, int sb) {
#pragma unroll
  for (int j = 0; j < SB; ++j) {
    x[j] *= rinv[sb + j];
#pragma unroll
    for (int i = j + 1; i < SB; ++i) x[i] -= x[j] * D[(sb + i) * DLD + sb + j];
  }
}

// Rows [0, n) of X (row stride ldx), columns sb + [0, 32): solved against
// L_ss, one row per thread.
template <typename T>
__device__ void solve_rows(T* X, int ldx, int n, const T* D, const T* rinv, int sb) {
  for (int i = threadIdx.x; i < n; i += NT) {
    T* row = X + i * ldx + sb;
    T x[SB];
#pragma unroll
    for (int j = 0; j < SB; ++j) x[j] = row[j];
    solve_sub(x, D, rinv, sb);
#pragma unroll
    for (int j = 0; j < SB; ++j) row[j] = x[j];
  }
}

// (A) partial Cholesky of the 128x128 diagonal block D (lower triangle) in
// shared memory, right-looking by 32-column sub-blocks; rinv[j] = 1/L[j][j].
template <typename T>
__device__ void factor_diag(T* D, T* rinv) {
  const int tid = threadIdx.x;
  for (int sb = 0; sb < TB; sb += SB) {
    // (A1) one warp factors the 32x32 sub-block in registers: lane i holds
    // row sb + i; column j's entries travel by shuffles.
    if (tid < 32) {
      const int i = tid;
      T x[SB];
      T my_rinv = T(0);
#pragma unroll
      for (int k = 0; k < SB; ++k) x[k] = k <= i ? D[(sb + i) * DLD + sb + k] : T(0);
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const T p = __shfl_sync(0xffffffffu, x[j], j);
        const T r = dev_rsqrt(p);
        if (i == j) {
          x[j] = p * r;
          my_rinv = r;
        } else if (i > j) {
          x[j] *= r;
        }
#pragma unroll
        for (int k = j + 1; k < SB; ++k) {
          const T lkj = __shfl_sync(0xffffffffu, x[j], k);
          if (i >= k) x[k] -= x[j] * lkj;
        }
      }
#pragma unroll
      for (int k = 0; k < SB; ++k)
        if (k <= i) D[(sb + i) * DLD + sb + k] = x[k];
      rinv[sb + i] = my_rinv;
    }
    __syncthreads();
    // (A2) rows below the sub-block inside the block, one per thread.
    const int base = sb + SB, nbelow = TB - base;
    solve_rows(D + base * DLD, DLD, nbelow, D, rinv, sb);
    __syncthreads();
    // (A3) downdate the rest of the block's lower triangle by the sub-block.
    if (nbelow) {
      smem_update(D + base * DLD + base, DLD, D + base * DLD + sb, DLD, D + base * DLD + sb, DLD,
                  nbelow / 8, nbelow / 8, SB, true);
      __syncthreads();
    }
  }
}

// (B) rows [lo, hi) of the slab below the block (row stride lda, columns
// from the block's first): l_r = a_r L11^-T, in chunks of XR rows staged in
// shared memory X, left-looking by 32-column sub-blocks: one product with
// the solved sub-blocks, then a row-parallel solve against L_ss.
template <typename T>
__device__ void solve_below(T* a, int lda, int lo, int hi, const T* D, const T* rinv, T* X) {
  const int tid = threadIdx.x;
  for (int r0 = lo; r0 < hi; r0 += XR) {
    const int n = min(XR, hi - r0);
#pragma unroll 8
    for (int e = tid; e < XR * TB; e += NT) {
      const int i = e / TB, c = e % TB;
      X[i * XLD + c] = i < n ? ldcg(a + (size_t)(r0 + i) * lda + c) : T(0);
    }
    __syncthreads();
    for (int sb = 0; sb < TB; sb += SB) {
      if (sb) {
        smem_update(X + sb, XLD, X, XLD, D + sb * DLD, DLD, XR / 8, SB / 8, sb, false);
        __syncthreads();
      }
      solve_rows(X, XLD, n, D, rinv, sb);
      __syncthreads();
    }
#pragma unroll 8
    for (int e = tid; e < XR * TB; e += NT) {
      const int i = e / TB, c = e % TB;
      if (i < n) a[(size_t)(r0 + i) * lda + c] = X[i * XLD + c];
    }
  }
}

// CTAs per cluster for a slab of mp rows: enough that each takes about 64
// of the first block's rows below it (a power of two, at most 16: 2 for a
// 256-row front, 16 from 768 rows).  A function of the shape only: never
// of the batch.
inline int cluster_size(int mp) {
  const int rows = (mp - TB) / GT;
  int cs = 1;
  while (cs < rows && cs < MAX_CLUSTER) cs *= 2;
  return cs;
}

// factor_slab's smem: the diagonal block, the pivots' reciprocals and a (B)
// chunk; (C) reuses it for its ring of operand stages.
template <typename T>
constexpr size_t factor_smem_bytes() {
  constexpr size_t ab = (size_t)TB * DLD + TB + (size_t)XR * XLD;
  constexpr size_t c = (size_t)NS * STAGE;
  return (ab > c ? ab : c) * sizeof(T);
}

// Partial Cholesky, in place, of the leading nfac columns of an (mp x ncols)
// row-major slab (row stride ncols) whose row i aligns with column i, by
// one cluster.  Per 128-column block: (A) factor the diagonal block in each
// CTA's smem, (B) solve the rows below it (split over the CTAs), (C)
// downdate the slab's trailing columns [off+TB, ncols) (lower tiles dealt
// over the CTAs).  Front: ncols = mp, nfac = nbp.  Panel: ncols = nfac = nb.
template <typename T>
__device__ void factor_slab(T* a, int mp, int ncols, int nfac, T* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lda = ncols;
  T* D = smem;
  T* rinv = D + TB * DLD;
  T* X = rinv + TB;

  for (int off = 0; off < nfac; off += TB) {
    const int t0 = off + TB;
    // (A) the diagonal block, factored by every CTA alike.
#pragma unroll 8
    for (int e = tid; e < TB * TB; e += NT) {
      const int r = e / TB, c = e % TB;
      D[r * DLD + c] = ldcg(a + (size_t)(off + r) * lda + off + c);
    }
    __syncthreads();
    factor_diag(D, rinv);

    // (B) this CTA's contiguous share of the rows below the block.
    const int per = (mp - t0 + cs - 1) / cs;
    const int lo = t0 + rank * per, hi = min(mp, lo + per);
    solve_below(a + off, lda, lo, hi, D, rinv, X);
    cluster.sync();  // every L21 row stored; every CTA done reading the block

    // CTA 0 stores L11 and the zeros above it.
    if (rank == 0) {
#pragma unroll 8
      for (int e = tid; e < TB * TB; e += NT) {
        const int r = e / TB, c = e % TB;
        a[(size_t)(off + r) * lda + off + c] = (r >= c) ? D[r * DLD + c] : T(0);
      }
      for (int e = tid; e < off * TB; e += NT) {
        const int r = e / TB, c = e % TB;
        a[(size_t)r * lda + off + c] = T(0);
      }
    }
    __syncthreads();  // D is reused as the operand stages below

    // (C) trailing downdate a[r, c] -= sum_k l[r, k] l[c, k], r >= c: lower
    // 64x64 tiles in row-major order, tile t to CTA t % cs.
    trailing_downdate(a, lda, off, t0, (mp - t0) / GT, (ncols - t0) / GT, rank, cs, smem);
    cluster.sync();  // the next block reads what (C) wrote
  }
}

// ----------------------------------------------------------------------
// Kernels and launches
// ----------------------------------------------------------------------
// One cluster per front: the cluster's first block index / cluster size is
// the front.
template <typename T>
__global__ void __launch_bounds__(NT) front_factor_kernel(T* a, int mp, int nbp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int front = blockIdx.x / cg::this_cluster().num_blocks();
  factor_slab<T>(a + (size_t)front * mp * mp, mp, mp, nbp, smem);
}

template <typename T>
__global__ void __launch_bounds__(NT) panel_factor_kernel(T* a, int mp, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  factor_slab<T>(a, mp, nb, nb, smem);
}

// syrk's K chunk: 32 in f64 (110.6 KB of stages), 64 in f32 (104.4 KB), so
// that two CTAs fit on an SM.
template <typename T>
__host__ __device__ constexpr int syrk_chunk() { return std::is_same<T, double>::value ? 32 : 64; }
template <typename T>
constexpr size_t syrk_smem_bytes() { return (size_t)NS * 2 * GT * (syrk_chunk<T>() + 4) * sizeof(T); }

// C - A A^T: the first n(n+1)/2 CTAs downdate the 64x64 tiles on or below
// the diagonal (tile t in row-major order), on the tensor cores in f64.
// FULL false (BLAS syrk, lower): one CTA per tile of the (m x m) output,
// the others copy the strictly-upper tiles from c unchanged.  FULL true: no
// more CTAs; each lower one writes its mirror tile too (lower_downdate's
// MIRROR).
template <typename T, bool FULL>
__global__ void __launch_bounds__(NT)
    syrk_kernel(const T* c, const T* a, T* out, int m, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n = m / GT, nlow = n * (n + 1) / 2;
  if (FULL || blockIdx.x < nlow) {
    lower_downdate<T, syrk_chunk<T>(), FULL>(a, k, k, c, out, m, n, n, blockIdx.x, nlow, smem);
    return;
  }
  // strictly-upper tile (tj, ti + 1): (ti, tj) runs over the lower tiles
  // of an (n - 1) x (n - 1) grid
  int ti, tj;
  lower_tile(blockIdx.x - nlow, n - 1, ti, tj);
  constexpr int V = 16 / sizeof(T), PER = GT * GT / V / NT;
  const size_t o = (size_t)(GT * tj) * m + GT * (ti + 1);
  uint4 x[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT;
    x[u] = *reinterpret_cast<const uint4*>(c + o + (size_t)(e / (GT / V)) * m + (e % (GT / V)) * V);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT;
    *reinterpret_cast<uint4*>(out + o + (size_t)(e / (GT / V)) * m + (e % (GT / V)) * V) = x[u];
  }
}

constexpr int EA = 32;  // extend-add tile edge; a CTA is EA x EA_ROWS threads
constexpr int EA_ROWS = 8;

// x + 0.0 turns -0 into +0 and leaves every other value alone: the host's
// mirrored block (low + low^T - diag) holds exactly these values.
template <typename T>
__global__ void __launch_bounds__(EA* EA_ROWS)
    extend_add_kernel(const T* __restrict__ src, long long lds, double* __restrict__ dst,
                      long long ldd, const int* __restrict__ pos, int n) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;
  __shared__ double tile[EA][EA + 1];
  __shared__ int prow[EA], pcol[EA];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = bi * EA, j0 = bj * EA;
  if (ty == 0) {
    prow[tx] = i0 + tx < n ? pos[i0 + tx] : 0;
    pcol[tx] = j0 + tx < n ? pos[j0 + tx] : 0;
  }
  for (int r = ty; r < EA; r += EA_ROWS) {
    const int i = i0 + r, j = j0 + tx;
    tile[r][tx] = (i < n && j <= i) ? static_cast<double>(src[(size_t)i * lds + j]) + 0.0 : 0.0;
  }
  __syncthreads();
  // (pos[i], pos[j]): on or below the parent's diagonal, along its rows
  for (int r = ty; r < EA; r += EA_ROWS) {
    const int i = i0 + r, j = j0 + tx;
    if (i < n && j <= i) {
      double* d = dst + (size_t)prow[r] * ldd + pcol[tx];
      *d = *d + tile[r][tx];
    }
  }
  // (pos[j], pos[i]), j < i: strictly above it, along its rows too
  for (int c = ty; c < EA; c += EA_ROWS) {
    const int j = j0 + c, i = i0 + tx;
    if (i < n && j < i) {
      double* d = dst + (size_t)pcol[c] * ldd + prow[tx];
      *d = *d + tile[tx][c];
    }
  }
}

template <typename T>
int launch_extend_add(const void* src, long long lds, void* dst, long long ldd, const void* pos,
                      int n, void* stream) {
  const int nt = (n + EA - 1) / EA;
  extend_add_kernel<T><<<dim3(nt, nt), dim3(EA, EA_ROWS), 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(src), lds, static_cast<double*>(dst), ldd,
      static_cast<const int*>(pos), n);
  return (int)cudaGetLastError();
}

// Launch configuration of one cluster per slab: `slabs` clusters of
// cluster_size(mp) CTAs.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int slabs, int mp, size_t smem, void* stream) {
    const int cs = cluster_size(mp);
    cfg.gridDim = dim3(slabs * cs);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of this shape the card can hold at once, or an error:
// a cluster that cannot be placed (too much smem, no room) is refused,
// never run some other way.  Asked once per device and cluster size, then
// cached, so a launch adds no query.
constexpr int MAX_DEVICES = 16;
template <auto kernel>
cudaError_t cluster_room(int mp, size_t smem, int* clusters) {
  static std::atomic<int> known[MAX_DEVICES][5];  // clusters + 1 by log2(size); 0: not asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int cs = cluster_size(mp);
  int slot = 0;
  while ((1 << slot) < cs) ++slot;
  if (dev < MAX_DEVICES && known[dev][slot].load() > 0) {
    *clusters = known[dev][slot].load() - 1;
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (cs > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  ClusterLaunch l(1, mp, smem, nullptr);
  e = cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg);
  if (e != cudaSuccess) return e;
  if (*clusters <= 0) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEVICES) known[dev][slot].store(*clusters + 1);
  return cudaSuccess;
}

template <typename T>
int launch_front(void* a, int batch, int mp, int nbp, void* stream) {
  const size_t smem = factor_smem_bytes<T>();
  int room = 0;
  cudaError_t e = cluster_room<front_factor_kernel<T>>(mp, smem, &room);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch l(batch, mp, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, front_factor_kernel<T>, static_cast<T*>(a), mp, nbp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_panel(void* a, int mp, int nb, void* stream) {
  const size_t smem = factor_smem_bytes<T>();
  int room = 0;
  cudaError_t e = cluster_room<panel_factor_kernel<T>>(mp, smem, &room);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch l(1, mp, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, panel_factor_kernel<T>, static_cast<T*>(a), mp, nb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int front_room(int mp, int* cluster, int* clusters) {
  *cluster = cluster_size(mp);
  return (int)cluster_room<front_factor_kernel<T>>(mp, factor_smem_bytes<T>(), clusters);
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, smem) and the
// largest shared-memory carveout (so that two such CTAs share an SM), once
// per device, not on every launch.
template <auto kernel>
cudaError_t smem_opt_in(size_t smem) {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return e;
}

template <typename T, bool FULL>
int run_syrk(const void* c, const void* a, void* out, int m, int k, void* stream) {
  constexpr size_t smem = syrk_smem_bytes<T>();
  cudaError_t e = smem_opt_in<syrk_kernel<T, FULL>>(smem);
  if (e != cudaSuccess) return (int)e;
  const int n = m / GT;
  syrk_kernel<T, FULL><<<FULL ? n * (n + 1) / 2 : n * n, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(a), static_cast<T*>(out), m, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_syrk(const void* c, const void* a, void* out, int m, int k, int lower,
                void* stream) {
  return (lower ? run_syrk<T, false> : run_syrk<T, true>)(c, a, out, m, k, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (or
// the error that refused the launch).
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
// lower != 0: uplo='L' (the strictly-upper part is c's); 0: the full result.
int syrk_downdate_f32(const void* c, const void* a, void* out, int m, int k, int lower,
                      void* stream) {
  return launch_syrk<float>(c, a, out, m, k, lower, stream);
}
int syrk_downdate_f64(const void* c, const void* a, void* out, int m, int k, int lower,
                      void* stream) {
  return launch_syrk<double>(c, a, out, m, k, lower, stream);
}
// dst[pos[i] * ldd + pos[j]] += src[i * lds + j] over j <= i < n, and the
// mirror for j < i; dst float64, src the named type, pos int32.
int extend_add_f32(const void* src, long long lds, void* dst, long long ldd, const void* pos,
                   int n, void* stream) {
  return launch_extend_add<float>(src, lds, dst, ldd, pos, n, stream);
}
int extend_add_f64(const void* src, long long lds, void* dst, long long ldd, const void* pos,
                   int n, void* stream) {
  return launch_extend_add<double>(src, lds, dst, ldd, pos, n, stream);
}
// The cluster that factors an (mp x mp) front (panel_factor: an mp-row
// slab): its CTA count, and how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters).  Launches nothing; the stream is unused.
int front_cluster_room_f32(int mp, int* cluster, int* clusters, void* stream) {
  (void)stream;
  return front_room<float>(mp, cluster, clusters);
}
int front_cluster_room_f64(int mp, int* cluster, int* clusters, void* stream) {
  (void)stream;
  return front_room<double>(mp, cluster, clusters);
}
// Message for an error code of any entry point of the library (the
// flash-attention entry points included).
const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
