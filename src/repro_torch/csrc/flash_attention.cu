// Forward flash attention (online softmax), written by hand for Hopper
// (sm_90a).  Plain C entry points, built with the other csrc sources by
// repro_torch/kernels/_build.py and called from
// repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py:
//   flash_wgmma_kernel, flash_tf32_kernel (each also as a cluster),
//   flash_fwd_kernel <- flash_attention (:77) / _flash_body (:31)
//
// What it computes (as the TPU kernel does): for Q, K, V of shape
// (B, T, H, Dh), K and V already repeated to the query head count,
//   O = softmax(scale * Q K^T [causal: key <= query, else -1e30]) V,
// scale = Dh^-0.5, the running (max, sum, accumulator) in f32, the final
// division by max(l, 1e-30), one rounding to the input type (f32 or bf16) on
// the store.  No logsumexp, no backward pass.
//
// On the TPU the KV grid axis runs in order and carries the running state in
// VMEM scratch between grid steps.  Blocks on Hopper run in no order, so one
// CTA owns one (batch*head, query tile) and loops over the KV tiles itself.
// Causal: the tensor-core kernels schedule query tiles longest first across
// every (batch, head) (the grid's fast axis is batch*head, its slow axis
// runs from the last query tile; the CUDA-core kernel, within each head,
// batch*head on its y axis, one launch per 65535 of them), KV
// tiles wholly in the future are not visited, and the mask is applied only
// on tiles that cross the diagonal or the end of T.
// Keys past T get probability exactly 0 (-inf), query rows past T are not
// stored.  The output is written contiguous (B, T, H, Dh).  The tensor-core
// kernels take the exponent in base 2: p = 2^(s c - m) with c carrying
// log2(e), by one FMA and one ex2.
//
// What bounds it on this card: operations.  At the main-path shape (B=2,
// T=4096, H=32, Dh=128, causal) the function does ~2.75e11 flops while
// moving ~268 MB in bf16 (~537 MB in f32), far above the ridge of every
// unit.  So every product goes to the tensor cores, in routes chosen by
// the wrapper from (dtype, Dh):
//
// The two tensor-core kernels take every Dh <= 256 (a multiple of 8): each
// is built for tiles of DHP = 64, 128, 192 and 256 columns and runs a Dh
// padded with zero columns in shared memory to the narrowest tile that
// holds it.  Zero columns add exactly 0 to every Q K^T dot product, the
// k-steps of S that hold only padding are not issued, PV runs at the padded
// width, and the output columns past Dh are never stored.  The scale is the
// true Dh's.  Dh 64, 128, 192 and 256 run instantiations without padding
// (PAD false: every bound a compile-time constant).  Past 128 columns the
// tiles of Q and two K/V stages no longer fit a CTA's 227 KiB at the narrow
// widths' key counts, so both kernels take fewer keys per K/V tile there.
//
// * flash_wgmma_kernel (bf16, Dh <= 256).  One CTA per 128-row query
//   tile: a producer warpgroup (one thread issues TMA, registers given back
//   by setmaxnreg) and two consumer warpgroups of 64 query rows each.  TMA
//   loads Q once and K and V tiles of WK keys (128 up to DHP 128, 64 past
//   it: Q + 2 (K + V) is 144 KiB at DHP 192, 192 KiB at 256) through a ring
//   of two stages (mbarriers: full per operand, empty per stage); the
//   tensor is 4-D (Dh, H, T, B) with its own strides and the true Dh, one
//   box is 64 Dh-columns (128 B) x 128 (Q) or WK (K, V) rows, 128-byte
//   swizzled; the box columns past Dh, like the rows past T, arrive as
//   zeros (and count as delivered bytes on the mbarrier).  S = Q K^T is
//   wgmma m64n{WK}k16 with both operands in shared memory (K-major), scaled
//   in f32 afterwards (in the exponent's FMA; q scale is not representable
//   in bf16).  The reference keeps P in f32; one rounding of P to bf16 would
//   cost about 2^-9 |v| sqrt(sum p^2) / l, which does not shrink with |O|.
//   So P is split in registers into P_hi = bf16(P) and P_lo = bf16(P -
//   P_hi), and PV is two register-A wgmmas per k16 step against the same V
//   tile (MN-major, no transpose): m64n{DHP}k16 up to DHP 128, past it one
//   n128 over V's boxes 0-1 and one n64 (DHP 192) or n128 (256) over the
//   rest, leaving an error of at most 2^-17 of sum p |v| / l.  A consumer
//   warpgroup whose 64 rows all lie past T does nothing.  O takes DHP/2
//   f32 registers per consumer thread (128 at DHP 256), within the 232 that
//   setmaxnreg gives them.  S takes ceil(Dh/16) k16 steps: one complete
//   wgmma stage is compiled for each count the tile can need, so no branch
//   falls inside a stage.  With 64-key tiles the first warpgroup skips the
//   CTA's last tile under the causal mask (wholly past its rows).
// * flash_tf32_kernel (f32, Dh <= 256).  TF32 alone misses the f32
//   tolerance, so both products use the 3xTF32 split a = a_big + a_small
//   (each rounded to TF32, nearest, ties away from zero, by two integer
//   operations: the bits of cvt.rna.tf32.f32, which costs more issue time),
//   a b ~ a_big b_big + a_big b_small + a_small b_big,
//   on mma.sync m16n8k8 (8 warps, each 16 query rows), the three products
//   of a group of independent output blocks issued pass by pass.  Q (scaled
//   in f32, as the reference does) and K and V tiles of FK keys (64 up to
//   DHP 128, 32 at 192, 16 at 256: the Q tile takes 100 and 130 KiB there)
//   come through a cp.async double buffer (the columns past Dh zero-filled,
//   never read from device memory) and are split as their fragments are
//   read; S takes Dh/8 k8 steps.  S and P stay in registers.  P's
//   accumulator layout feeds the A operand directly by permuting the keys
//   of each 8-key step (A column t <-> key 2t, t+4 <-> 2t+1; V's rows are
//   read in the same order).
// * The cluster route (Dh 264 .. 4096, bf16 and f32): the same two kernels
//   (CLUSTER true) with the head dim split over a thread-block cluster of
//   nc = ceil(Dh / 256) CTAs along x, each holding an equal share of the
//   columns rounded up to 64 (192 or 256: two CTAs of 192 at Dh 320, four
//   of 256 at Dh 1000, sixteen at 4096, the H100's largest cluster).  A CTA
//   loads its share of Q, K and V (TMA box offset on the Dh axis; cp.async
//   from its first column), computes the partial S of its rows over it on
//   the tensor cores, and the cluster adds the nc partials in rank order
//   through distributed shared memory (cluster_sum): each CTA then holds
//   the same S, m and l, and runs the softmax, PV over its own V columns,
//   and stores its own O columns.  S is computed once, not once per chunk
//   of O.  bf16 keeps its tiles and adds 32 KiB of partial slots (231,424 B
//   at share 256).  f32 holds one K and one V tile of 56 (share 192) or 32
//   (256) keys instead of two stages of 32 or 16, each loaded while the
//   other is read, so that an exchange spans more keys (the exchange, not
//   the products, is what the cluster adds).  Causal skips depend on
//   the query tile and the warp only, so every CTA of a cluster makes the
//   same exchanges.
// * flash_fwd_kernel (route simt, the first kernel; the wrapper gives it
//   every Dh past the cluster's reach, 4096, in steps of 8): f32 math on
//   the CUDA cores, operands from shared memory.  A CTA owns one 128-column
//   chunk of O (grid.z): it computes S over the full Dh by streaming Q and
//   K through shared memory in 128-column chunks, in column order, and
//   reads only its chunk of V.  S is recomputed by every chunk of O.
//
// No atomics and a fixed summation order: two calls give the same bits.
#include <cuda.h>  // CUtensorMap and its enums (types only: no driver library is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr int MAX_CLUSTER = 16;  // the H100 holds clusters of 16 (non-portable past 8)
constexpr int CLUSTER_DH_MAX = 256 * MAX_CLUSTER;  // the cluster route's reach

struct Strides {
  long long b, t, h, d;
};

// ----------------------------------------------------------------------
// flash_fwd_kernel (route simt, Dh past the cluster route's 4096): one CTA
// per (batch*head, 64-row query tile, 128-column chunk of O), 64-key KV
// tiles, 256 threads as 16x16
// each owning 4x4 scores and 4 x 8 outputs; any strides.  S over the full
// Dh comes from Q and K streamed through f32 shared memory 128 columns at a
// time (rows padded to 129 floats), in column order; V's chunk of O and P
// (rows padded to 65) stay for the tile.
// ----------------------------------------------------------------------
constexpr int BQ = 64;    // query rows per CTA
constexpr int BKV = 64;   // keys per KV tile
constexpr int NT = 256;   // threads per CTA (16 x 16)
constexpr int NC = 8;     // 16-wide column chunks of a thread's share of O
constexpr int DC = 16 * NC;   // columns of a Q/K chunk and of the CTA's O
constexpr int LDC = DC + 1;   // padded row stride of the Q, K and V tiles
constexpr int PLD = BKV + 1;  // padded row stride of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Copy rows [r0, r0 + rows) of one (batch, head)'s (T, Dh) slice, `cols`
// columns of it, into a (rows x LDC) f32 tile, times `mul`; rows past T are
// zero.
template <typename Elem>
__device__ void load_tile(const Elem* base, Strides s, int r0, int rows,
                          int seq, int cols, float mul, float* tile) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, d = e - r * cols;
    const int t = r0 + r;
    tile[r * LDC + d] = t < seq ? to_f32(base[t * s.t + d * s.d]) * mul : 0.f;
  }
}

template <typename Elem>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                     const Elem* __restrict__ v, Elem* __restrict__ out,
                     int heads, int seq, int dh, int causal, float scale,
                     Strides sq, Strides sk, Strides sv, int bh0) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // BQ  x LDC
  float* Ks = Qs + BQ * LDC;   // BKV x LDC
  float* Vs = Ks + BKV * LDC;  // BKV x LDC
  float* Ps = Vs + BKV * LDC;  // BQ  x PLD

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int bh = bh0 + blockIdx.y;  // this launch's batch*head block
  const int b = bh / heads, h = bh % heads;
  const int c0 = blockIdx.z * DC;  // the CTA's columns of O
  const int dc = min(DC, dh - c0);
  const float neg_inf_f32 = __int_as_float(0xff800000);

  const Elem* qb = q + b * sq.b + h * sq.h;
  const Elem* kb = k + b * sk.b + h * sk.h;
  const Elem* vb = v + b * sv.b + h * sv.h + c0 * sv.d;

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // causal: visit only tiles that start at or before the tile's last row
  const int kv_end = causal ? min(seq, q0 + BQ) : seq;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done

    // S = (scale Q) K^T for the thread's 4 x 4 entries, Q and K by
    // DC-column chunks in column order; V's chunk of O rides with the first
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += DC) {
      const int w = min(DC, dh - d0);
      if (d0) __syncthreads();  // the previous chunk's readers are done
      load_tile(qb + d0 * sq.d, sq, q0, BQ, seq, w, scale, Qs);
      load_tile(kb + d0 * sk.d, sk, kv0, BKV, seq, w, 1.f, Ks);
      if (!d0) load_tile(vb, sv, kv0, BKV, seq, dc, 1.f, Vs);
      __syncthreads();
      for (int d = 0; d < w; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LDC + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LDC + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
    }

    // online softmax, row by row; the 16 lanes of a row reduce by shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kv0 + tx + 16 * j;
        if (kj >= seq)
          s[i][j] = neg_inf_f32;  // past the end: probability exactly 0
        else if (causal && kj > qi)
          s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V (the CTA's dc columns)
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < dc ? Vs[j * LDC + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    Elem* o = out + (((long long)b * seq + t) * heads + h) * dh + c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dc) o[d] = from_f32<Elem>(acc[i][c] / den);
    }
  }
}

template <typename Elem>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int batch, int seq, int heads, int dh, int causal,
                 float scale, Strides sq, Strides sk, Strides sv,
                 void* stream) {
  // every narrower Dh goes to the tensor-core kernels and their clusters
  if (dh <= CLUSTER_DH_MAX || dh % 8) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(BQ + 2 * BKV) * LDC + (size_t)BQ * PLD) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<Elem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // query tiles on x (each head's longest first), batch*head on y, split
  // into launches of at most 65535 (the y extent), the chunks of O on z
  const int bh = batch * heads;
  for (int bh0 = 0; bh0 < bh; bh0 += 65535) {
    dim3 grid((seq + BQ - 1) / BQ, min(65535, bh - bh0), (dh + DC - 1) / DC);
    flash_fwd_kernel<Elem><<<grid, NT, smem, (cudaStream_t)stream>>>(
        static_cast<const Elem*>(q), static_cast<const Elem*>(k),
        static_cast<const Elem*>(v), static_cast<Elem*>(out), heads, seq, dh,
        causal, scale, sq, sk, sv, bh0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}


// ----------------------------------------------------------------------
// Tensor-core routes: shared pieces
// ----------------------------------------------------------------------
constexpr int TQ = 128;  // query rows per CTA of the tensor-core routes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Online softmax over one key tile for the two rows a thread holds in a
// 16-row MMA accumulator: s[4j + e] is row row[e >> 1], key
// kv0 + 8j + c2 + (e & 1).  Masks (only when `mask`), folds the tile into
// the running max m and sum l, leaves p in s and returns in corr the factor
// that rescales the rows' accumulators.  The four lanes that share a row
// reduce by shuffles.
//   EXP2 false: p = exp(s scale - m), s scaled first (the reference's order).
//   EXP2 true:  p = 2^(s scale - m) by one FMA and one ex2, where scale
//               carries log2(e) and m is in the same base-2 units; the max is
//               taken over the unscaled s (scale > 0, rounding is monotone:
//               the same max).
template <int NJ, bool EXP2>
__device__ __forceinline__ void softmax_tile(float (&s)[4 * NJ], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int kv0, int c2,
                                             const int (&row)[2], int seq, int causal,
                                             bool mask, float scale) {
  const float neg_inf_f32 = __int_as_float(0xff800000);
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = EXP2 ? s[4 * j + e] : s[4 * j + e] * scale;
      if (mask) {
        const int key = kv0 + 8 * j + c2 + (e & 1);
        if (key >= seq)
          x = neg_inf_f32;  // past the end: probability exactly 0
        else if (causal && key > row[e >> 1])
          x = NEG_INF;
      }
      s[4 * j + e] = x;
      mt[e >> 1] = fmaxf(mt[e >> 1], x);
    }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float mn = fmaxf(m[r], EXP2 ? mt[r] * scale : mt[r]);
    corr[r] = EXP2 ? exp2f(m[r] - mn) : expf(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e], mr = m[e >> 1];
      const float p = EXP2 ? exp2f(fmaf(x, scale, -mr)) : expf(x - mr);
      s[4 * j + e] = p;
      ps[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
    ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
    l[r] = l[r] * corr[r] + ps[r];
  }
}

// ----------------------------------------------------------------------
// bf16: warpgroup MMA fed by TMA
// ----------------------------------------------------------------------
constexpr int WSTAGES = 2;             // K/V ring stages
constexpr int QBOX = TQ * 128;         // bytes of one Q box: 128 rows x 64 bf16
constexpr int WTHREADS = 384;          // producer warpgroup + 2 consumer warpgroups
constexpr int CL_WARPS = 8;  // consumer warps of either tensor-core kernel (cluster slots)

// Keys per K/V tile: 128 up to a 128-column tile; 64 past it, where Q and
// two stages of 128-key K and V tiles would take 240 KiB (192 columns) or
// 320 KiB (256) of a CTA's 227 KiB.
template <int DH>
__host__ __device__ constexpr int wg_keys() { return DH <= 128 ? 128 : 64; }
// bytes of one K or V box: wg_keys rows x 64 bf16
template <int DH>
__host__ __device__ constexpr int wg_kv_box() { return wg_keys<DH>() * 128; }
// bytes of the partial-S slots of a cluster's CTA: 8 warps x 32 lanes x
// wg_keys / 2 f32 (32 KiB with 64-key tiles)
template <int DH>
__host__ __device__ constexpr int wg_part_bytes() { return CL_WARPS * 32 * (wg_keys<DH>() / 2) * 4; }
// Q, the K and V stages, the partial-S slots (cluster), the mbarriers, and
// slack to align the base to 1 KB (DH 256: 64 + 2 (32 + 32) KiB + 2 KiB,
// 32 KiB more in a cluster: 231,424 of 232,448 B)
template <int DH, bool CLUSTER = false>
__host__ __device__ constexpr int wg_smem_bytes() {
  return (DH / 64) * (QBOX + 2 * WSTAGES * wg_kv_box<DH>()) + (CLUSTER ? wg_part_bytes<DH>() : 0) +
         1024 + 1024;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// One TMA box of a 4-D map into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ----------------------------------------------------------------------
// Head dims past 256: the columns split over a thread-block cluster
// ----------------------------------------------------------------------
// Each CTA of a cluster of nc holds one share of DH columns (DH 192 or 256)
// of Q, K, V and O.  Per key tile each consumer warp computes the partial
// S of its rows over its CTA's columns, stores it in its slot of the CTA's
// shared memory, and adds the slots of the same warp in every CTA, read
// through distributed shared memory in rank order 0..nc-1: every CTA holds
// the same bits of S (and so of m, l and P).  Two mbarriers per consumer
// warp take one arrival from that warp in each CTA: `full` (every partial
// of the tile is stored: a release fence on shared memory before the
// arrivals, acquired by the wait) and `empty` (every CTA has read this
// CTA's partial, which may then be overwritten).  A warp
// waits on `empty` only before its next store, so the wait for the peers'
// reads overlaps the softmax, PV and the next tile's S.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every CTA of the cluster, after the mbarriers' init.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// The same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// A relaxed arrival on the mbarrier at a cluster address: it orders no
// memory access by itself.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Release, at cluster scope, the shared-memory stores that precede it (the
// warp's, through __syncwarp) to the acquire of a later arrival's waiter.
// Restricted to shared memory, it does not wait on global memory as the
// release of mbarrier.arrive.release.cluster does: that release, at both
// arrivals, took 6.5 ms of bf16's, against 4.2 with this fence (B=2 T=4096
// H=32 Dh=320 causal, NVIDIA H100 80GB HBM3).
__device__ __forceinline__ void fence_shared_release_cluster() {
  asm volatile("fence.release.sync_restrict::shared::cta.cluster;\n" ::: "memory");
}
// mbar_wait, acquiring what the cluster's arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// One consumer warp's side of the exchange: its slot (N/4 float4s per
// lane, lane-interleaved: conflict-free), its two mbarriers, the exchanges
// so far, the cluster's size and the CTA's rank in it.
struct ClusterSlot {
  float4* slot;
  uint64_t* full;
  uint64_t* empty;
  uint32_t n;
  uint32_t nc;
  uint32_t rank;
};

// s (the warp's partial S, N floats a lane) becomes the cluster's S,
// p_0 + p_1 + ... + p_{nc-1} added in that order.  Ranks 0 and 1 hold p_0
// and p_1 in s (p_0 + p_1 == p_1 + p_0 exactly) and add the others to it;
// a higher rank rebuilds the sum from the slots, its own read locally.
template <int N>
__device__ __forceinline__ void cluster_sum(float (&s)[N], ClusterSlot& x, int lane) {
  static_assert(N % 4 == 0, "whole float4s per lane");
  if (x.n > 0) mbar_wait_cluster(x.empty, (x.n - 1) & 1);  // the peers read the last one
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    x.slot[32 * j + lane] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  __syncwarp();
  if (lane == 0) {
    fence_shared_release_cluster();  // the slot's stores before the arrivals
    for (uint32_t r = 0; r < x.nc; ++r) mbar_arrive_remote(cluster_addr(smem_u32(x.full), r));
  }
  mbar_wait_cluster(x.full, x.n & 1);
  const bool in_place = x.rank < 2;
  const uint32_t a = smem_u32(x.slot + lane);
  for (uint32_t r = 0; r < x.nc; ++r) {
    if (in_place && r == x.rank) continue;  // already in s
    float4 p[N / 4];
    if (r == x.rank) {  // its own partial: a plain shared load, off the cluster's network
#pragma unroll
      for (int j = 0; j < N / 4; ++j) p[j] = x.slot[32 * j + lane];
    } else {
      const uint32_t ra = cluster_addr(a, r);
#pragma unroll
      for (int j = 0; j < N / 4; ++j) p[j] = ld_cluster(ra + 32 * 16 * j);
    }
    const bool first = r == 0 && !in_place;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      s[4 * j + 0] = first ? p[j].x : s[4 * j + 0] + p[j].x;
      s[4 * j + 1] = first ? p[j].y : s[4 * j + 1] + p[j].y;
      s[4 * j + 2] = first ? p[j].z : s[4 * j + 2] + p[j].z;
      s[4 * j + 3] = first ? p[j].w : s[4 * j + 3] + p[j].w;
    }
  }
  // every lane's loads have returned (their values were added above) before
  // the arrivals issue: no peer's next store can reach them
  __syncwarp();
  if (lane == 0)
    for (uint32_t r = 0; r < x.nc; ++r) mbar_arrive_remote(cluster_addr(smem_u32(x.empty), r));
  ++x.n;
}
// Before the CTA exits: every CTA has read its last partial.
__device__ __forceinline__ void cluster_drain(const ClusterSlot& x) {
  if (x.n > 0) mbar_wait_cluster(x.empty, (x.n - 1) & 1);
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address; leading offset `lbo` bytes (K-major: unused; MN-major: from one
// 64-element swizzle atom to the next along M/N, here from box to box);
// stride 1024 B between groups of 8 rows of 128 B (the swizzle atom TMA
// writes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) asm volatile("" : "+r"(r[i][u])::"memory");
}

// d += A B, A from registers (bf16 pairs), B from shared memory, MN-major (transposed), m64n128k16.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A B, A and B from shared memory (descriptors), m64n128k16, bf16 -> f32.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A B, A and B from shared memory (descriptors), m64n64k16, bf16 -> f32.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B, A from registers (bf16 pairs), B from shared memory, MN-major (transposed), m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T over the first N k16 steps of Dh: 64 x wg_keys per warpgroup,
// one complete wgmma stage (fence, products, commit, wait).  Step kk reads
// 32 bytes on in box kk / 4 of Q and of K.
template <int DH, int N>
__device__ __forceinline__ void qk_wgmma(float (&s)[wg_keys<DH>() / 2], uint32_t qa, uint32_t kb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    const uint64_t da = sw128_desc(qa + (kk / 4) * QBOX + (kk % 4) * 32);
    const uint64_t db = sw128_desc(kb + (kk / 4) * wg_kv_box<DH>() + (kk % 4) * 32);
    if constexpr (wg_keys<DH>() == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
}
// The same for a run-time count LO <= nk <= N: the branch picks a whole
// stage, so none falls between a stage's products.
template <int DH, int N, int LO>
__device__ __forceinline__ void qk_wgmma_steps(float (&s)[wg_keys<DH>() / 2], uint32_t qa,
                                               uint32_t kb, int nk) {
  if constexpr (N > LO) {
    if (nk < N) {
      qk_wgmma_steps<DH, N - 1, LO>(s, qa, kb, nk);
      return;
    }
  }
  qk_wgmma<DH, N>(s, qa, kb);
}

// One CTA per (batch*head, 128-row query tile): warpgroup 0 produces (one
// thread issues every TMA load), warpgroups 1 and 2 each own 64 query rows;
// a consumer warpgroup whose rows all lie past T does nothing.  DH is the
// tile width (64, 128, 192 or 256 columns); PAD: the head dim dh_arg is
// narrower (a multiple of 8 above the next narrower tile), else it is DH
// and every bound below is a compile-time constant.  CLUSTER: one cluster
// of ceil(dh_arg / DH) CTAs per (batch*head, query tile), along x, each
// CTA holding DH columns from rank * DH (the last one's past dh_arg read as
// zeros), S summed across the cluster (cluster_sum).
template <int DH, bool PAD, bool CLUSTER>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       int heads, int seq, int dh_arg, int causal, float scale) {
  const int nc = CLUSTER ? (int)cluster_nctarank() : 1;
  const int col0 = CLUSTER ? (int)cluster_ctarank() * DH : 0;  // the CTA's first column
  const int dh = CLUSTER ? min(DH, dh_arg - col0) : PAD ? dh_arg : DH;  // the columns it holds
  const int ldo = CLUSTER ? dh_arg : dh;  // the output's row stride
  constexpr int NB = DH / 64;  // 64-column boxes per tile
  constexpr int WK = wg_keys<DH>();
  constexpr int KVBOX = wg_kv_box<DH>();
  constexpr int KVTILE = NB * KVBOX;
  extern __shared__ __align__(1024) uint8_t wsmem[];
  uint8_t* base = wsmem + ((1024 - (smem_u32(wsmem) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + NB * QBOX;
  uint8_t* Vs = Ks + WSTAGES * KVTILE;
  float4* part = reinterpret_cast<float4*>(Vs + WSTAGES * KVTILE);  // cluster: partial-S slots
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(Vs + WSTAGES * KVTILE + (CLUSTER ? wg_part_bytes<DH>() : 0));
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + WSTAGES;
  uint64_t* empty = v_full + WSTAGES;
  uint64_t* s_full = empty + WSTAGES;  // cluster: one per consumer warp
  uint64_t* s_empty = s_full + CL_WARPS;

  const int bh = blockIdx.x / nc;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // longest rows first
  const int kv_end = causal ? min(seq, q0 + TQ) : seq;
  const int ntiles = (kv_end + WK - 1) / WK;
  const int wg = threadIdx.x >> 7;
  const int consumers = q0 + 64 < seq ? 2 : 1;  // warpgroups with rows inside T

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < WSTAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, 4 * consumers);  // one arrival per working consumer warp
    }
    if constexpr (CLUSTER) {
      for (int w = 0; w < CL_WARPS; ++w) {
        mbar_init(s_full + w, nc);
        mbar_init(s_empty + w, nc);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CLUSTER)
    cluster_sync();  // no remote arrival before every peer's init
  else
    __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NB * QBOX);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_4d(Qs + c * QBOX, &tq, q_full, col0 + 64 * c, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % WSTAGES;
        if (it >= WSTAGES) mbar_wait(empty + st, ((it / WSTAGES) - 1) & 1);
        mbar_expect_tx(k_full + st, KVTILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_4d(Ks + st * KVTILE + c * KVBOX, &tk, k_full + st, col0 + 64 * c, h, it * WK,
                      b);
        mbar_expect_tx(v_full + st, KVTILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_4d(Vs + st * KVTILE + c * KVBOX, &tv, v_full + st, col0 + 64 * c, h, it * WK,
                      b);
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int c2 = 2 * (lane & 3);
    const int rbase = q0 + 64 * cw;  // the warpgroup's first query row
    const int row[2] = {rbase + 16 * warp + (lane >> 2), rbase + 16 * warp + (lane >> 2) + 8};
    const uint32_t qa = smem_u32(Qs) + 64 * cw * 128;  // the warpgroup's 64 rows of each box
    const float scale_log2 = scale * 1.4426950408889634f;  // p = 2^(s scale log2(e) - m)
    // k16 steps of S that hold some of Dh (a cluster's CTAs run in step:
    // every one takes all of its share's)
    const int nk = CLUSTER ? DH / 16 : (dh + 15) / 16;
    // causal: a 64-key tile wholly past the warpgroup's last row (the CTA's
    // last, for the first warpgroup) adds exactly nothing and is not
    // visited; no later load waits for its stage.  Rows all past T: none.
    const int wg_tiles = rbase >= seq ? 0 : causal ? (min(seq, rbase + 64) + WK - 1) / WK : ntiles;
    ClusterSlot xs{part + (4 * cw + warp) * (WK / 8) * 32, s_full + 4 * cw + warp,
                   s_empty + 4 * cw + warp, 0, (uint32_t)nc, (uint32_t)(col0 / DH)};

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < wg_tiles; ++it) {
      const int st = it % WSTAGES;
      const uint32_t ph = (it / WSTAGES) & 1;
      const int kv0 = it * WK;
      const uint32_t kb = smem_u32(Ks + st * KVTILE);
      const uint32_t vb = smem_u32(Vs + st * KVTILE);

      // S = Q K^T: 64 x WK per warpgroup, k16 steps along Dh
      float s[WK / 2];
#pragma unroll
      for (int i = 0; i < WK / 2; ++i) s[i] = 0.f;
      mbar_wait(k_full + st, ph);
      qk_wgmma_steps<DH, DH / 16, DH / 16 - 3>(s, qa, kb, nk);
      fence_regs(s);
      if constexpr (CLUSTER) cluster_sum(s, xs, lane);

      const bool mask = kv0 + WK > seq || (causal && kv0 + WK - 1 > rbase);
      float corr[2];
      softmax_tile<WK / 8, true>(s, m, l, corr, kv0, c2, row, seq, causal, mask, scale_log2);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        o[4 * i + 0] *= corr[0];
        o[4 * i + 1] *= corr[0];
        o[4 * i + 2] *= corr[1];
        o[4 * i + 3] *= corr[1];
      }
      // P as register A operands, k16 step kk = keys 16kk + [0, 16):
      // a[u] = (s[8kk + 2u], s[8kk + 2u + 1]), split into hi + lo.
      uint32_t phi[WK / 16][4], plo[WK / 16][4];
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float x = s[8 * kk + 2 * u], y = s[8 * kk + 2 * u + 1];
          const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
          phi[kk][u] = *reinterpret_cast<const uint32_t*>(&hv);
          plo[kk][u] = pack_bf16(x - __low2float(hv), y - __high2float(hv));
        }

      // O += P_hi V + P_lo V
      mbar_wait(v_full + st, ph);
      fence_regs(o);
      wgmma_fence();
      // k16 step kk: keys 16kk + [0, 16) of V, 2048 bytes on.  Boxes 0-1 in
      // one n128 product (leading offset: one box), then box 2 (n64) or
      // boxes 2-3 (n128) into the accumulator's next 64 registers.
      auto pv = [&](const uint32_t(&a)[4], int kk) {
        const uint32_t vk = vb + kk * 2048;
        if constexpr (NB == 1) {
          wgmma_rs_n64(o, a, sw128_desc(vk));
        } else {
          wgmma_rs_n128(o, a, sw128_desc(vk, KVBOX));
          if constexpr (NB == 3) wgmma_rs_n64(o + 64, a, sw128_desc(vk + 2 * KVBOX));
          if constexpr (NB == 4) wgmma_rs_n128(o + 64, a, sw128_desc(vk + 2 * KVBOX, KVBOX));
        }
      };
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) pv(phi[kk], kk);
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) pv(plo[kk], kk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      fence_regs(phi);
      fence_regs(plo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= seq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = out + (((size_t)b * seq + row[r]) * heads + h) * ldo + col0;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        if (8 * i >= dh) break;  // padding columns are not stored
        const __nv_bfloat162 v2 =
            __floats2bfloat162_rn(o[4 * i + 2 * r] / den, o[4 * i + 2 * r + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + c2) = v2;
      }
    }
    if constexpr (CLUSTER) cluster_drain(xs);
  }
}

// ----------------------------------------------------------------------
// f32: 3xTF32 on mma.sync
// ----------------------------------------------------------------------
// The tiles of a DH-column head: query rows per CTA (16 per warp) and keys
// per K/V tile, so that the Q tile and two K/V stages, rows padded by 4
// floats, fit a CTA's 227 KiB: (128 + 4 * 64) * 132 * 4 B at DH 128, 32-key
// tiles at 192 (200,704 B), 16-key tiles at 256 (199,680 B).
template <int DH>
__host__ __device__ constexpr int tf32_rows() { return TQ; }
template <int DH>
__host__ __device__ constexpr int tf32_keys() { return DH <= 128 ? 64 : DH <= 192 ? 32 : 16; }
template <int DH>
__host__ __device__ constexpr int tf32_threads() { return 2 * tf32_rows<DH>(); }
// Keys per K/V tile of a cluster's CTA: one K and one V tile, each loaded
// while the other is read, in place of two stages of each, so that a tile
// (and an exchange) spans more keys: 56 at DH 192, 32 at 256, where Q, K, V
// and the partial-S slots (a warp's 16 rows x these keys, f32) and their
// mbarriers take 216,960 and 216,192 B.
template <int DH>
__host__ __device__ constexpr int tf32_cluster_keys() { return DH <= 192 ? 56 : 32; }
template <int DH, bool CLUSTER = false>
constexpr int tf32_smem_bytes() {
  return CLUSTER ? (tf32_rows<DH>() + 2 * tf32_cluster_keys<DH>()) * (DH + 4) * (int)sizeof(float) +
                       tf32_rows<DH>() * tf32_cluster_keys<DH>() * 4 + 2 * 8 * (tf32_rows<DH>() / 16)
                 : (tf32_rows<DH>() + 4 * tf32_keys<DH>()) * (DH + 4) * (int)sizeof(float);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits cvt.rna.tf32.f32 gives for finite x, by an add and a mask
// on the integer pipes, which issue faster than that conversion.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = big + small, each rounded to TF32 (small carries the next 11 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b on the tensor cores, one 16x8x8 TF32 product per warp (g =
// lane/4, t = lane%4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d[4n, 4n + 4) += a b_n for G column blocks n, b_n's fragment read at
// (p0[n step], p1[n step]), in about f32 accuracy: the three TF32 products
// of the split, smallest first, issued pass by pass so that consecutive
// products do not wait on each other.
template <int G>
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const float* p0,
                                           const float* p1, int step) {
  uint32_t bb[G][2], bs[G][2];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    split_tf32(p0[n * step], bb[n][0], bs[n][0]);
    split_tf32(p1[n * step], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < G; ++n) mma_tf32(d + 4 * n, as, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < G; ++n) mma_tf32(d + 4 * n, ab, bs[n][0], bs[n][1]);
#pragma unroll
  for (int n = 0; n < G; ++n) mma_tf32(d + 4 * n, ab, bb[n][0], bb[n][1]);
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// rows [r0, r0 + rows) of one (batch, head)'s (T, dh) slice into a tile of
// DH columns and row stride DH + 4; rows past T and columns past dh are zero
// (nothing is read for them).  16-byte copies: the wrapper hands this route
// only tensors whose rows are 16-byte aligned, and dh is a multiple of 8.
template <int DH>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, long long st,
                                                int r0, int rows, int seq, int dh) {
  constexpr int CH = DH / 4;  // 16-byte chunks per padded row
  for (int e = threadIdx.x; e < rows * CH; e += tf32_threads<DH>()) {
    const int r = e / CH, c = (e % CH) * 4;
    const int t = r0 + r;
    const bool valid = t < seq && c < dh;  // else nothing is read, from an address in the tensor
    cp_async16_zfill(dst + r * (DH + 4) + c,
                     src + (valid ? (long long)t * st : 0) + (c < dh ? c : 0), valid);
  }
}

// One CTA per (batch*head, tf32_rows query rows), a warp per 16 of them;
// tf32_keys-key K and V tiles through a cp.async double buffer.  DH is the
// padded tile width, PAD, CLUSTER and dh_arg as for flash_wgmma_kernel.
template <int DH, bool PAD, bool CLUSTER>
__global__ void __launch_bounds__(tf32_threads<DH>(), 1)
    flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int heads, int seq,
                      int dh_arg, int causal, float scale, Strides sq, Strides sk, Strides sv) {
  const int nc = CLUSTER ? (int)cluster_nctarank() : 1;
  const int col0 = CLUSTER ? (int)cluster_ctarank() * DH : 0;  // the CTA's first column
  const int dh = CLUSTER ? min(DH, dh_arg - col0) : PAD ? dh_arg : DH;  // the columns it holds
  const int ldo = CLUSTER ? dh_arg : dh;  // the output's row stride
  constexpr int LD = DH + 4;
  constexpr int ROWS = tf32_rows<DH>(), FK = tf32_keys<DH>();
  extern __shared__ __align__(16) float tsmem[];
  float* Qs = tsmem;             // ROWS x LD
  float* Kb = Qs + ROWS * LD;    // 2 stages of FK x LD
  float* Vb = Kb + 2 * FK * LD;
  // cluster: one K and one V tile of CK keys, then the partial-S slots
  constexpr int CK = tf32_cluster_keys<DH>();
  float4* part = reinterpret_cast<float4*>(Kb + 2 * CK * LD);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(part + ROWS * CK / 4);  // one per warp
  uint64_t* s_empty = s_full + ROWS / 16;

  const int bh = blockIdx.x / nc;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest rows first
  const int kv_end = causal ? min(seq, q0 + ROWS) : seq;
  const int ntiles = (kv_end + FK - 1) / FK;
  const float* qb = q + b * sq.b + h * sq.h + col0;  // the innermost stride is 1
  const float* kb = k + b * sk.b + h * sk.h + col0;
  const float* vb = v + b * sv.b + h * sv.h + col0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = q0 + 16 * warp;  // the warp's first query row
  const int row[2] = {wrow + g, wrow + g + 8};
  ClusterSlot xs{part + warp * (CK / 8) * 32, s_full + warp, s_empty + warp, 0, (uint32_t)nc,
                 (uint32_t)(col0 / DH)};
  if constexpr (CLUSTER) {
    if (threadIdx.x == 0) {
      for (int w = 0; w < ROWS / 16; ++w) {
        mbar_init(s_full + w, nc);
        mbar_init(s_empty + w, nc);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();  // no remote arrival before every peer's init
  }

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // S = (scale Q) K^T over the tile in Ks: 16 rows x 2N keys per warp (s:
  // N floats a lane)
  auto scores = [&](const float* Ks, auto& s) {
    constexpr int N = sizeof(s) / sizeof(float);
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = 0.f;
    auto qk = [&](int ks) {  // k8 step ks: Dh columns 8ks + [0, 8)
      const float* qa = Qs + (16 * warp + g) * LD + 8 * ks + t4;
      uint32_t ab[4], as[4];
      split_tf32(qa[0], ab[0], as[0]);
      split_tf32(qa[8 * LD], ab[1], as[1]);
      split_tf32(qa[4], ab[2], as[2]);
      split_tf32(qa[8 * LD + 4], ab[3], as[3]);
      const float* kp = Ks + g * LD + 8 * ks + t4;  // key 8j + g at kp + 8j LD
      // at most two key blocks at once past 192 columns, where O's 128
      // registers a lane leave no room for more split operands
      constexpr int G = DH > 192 && N / 4 > 2 ? 2 : N / 4;
#pragma unroll
      for (int j0 = 0; j0 < N / 4; j0 += G)
        mma_3xtf32<G>(s + 4 * j0, ab, as, kp + 8 * j0 * LD, kp + 8 * j0 * LD + 4, 8 * LD);
    };
    if constexpr (PAD) {  // the steps that hold some of Dh
#pragma unroll 2
      for (int ks = 0; ks < dh / 8; ++ks) qk(ks);
    } else {
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) qk(ks);
    }
  };
  // the online softmax of the tile of 2N keys from kv0 (S in s), then
  // O += P V with its V tile in Vs
  auto absorb = [&](auto& s, const float* Vs, int kv0) {
    constexpr int N = sizeof(s) / sizeof(float);
    const bool mask = kv0 + 2 * N > seq || (causal && kv0 + 2 * N - 1 > wrow);
    float corr[2];
    softmax_tile<N / 4, true>(s, m, l, corr, kv0, 2 * t4, row, seq, causal, mask,
                              1.4426950408889634f);  // p = 2^(s log2(e) - m)
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[4 * i + 0] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    // O += P V, 8 keys per step; A column t holds key 2t, column t+4 key
    // 2t+1 (the accumulator's own layout), so B row t reads V row 2t.
#pragma unroll
    for (int kk = 0; kk < N / 4; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(s[4 * kk + 0], ab[0], as[0]);
      split_tf32(s[4 * kk + 2], ab[1], as[1]);
      split_tf32(s[4 * kk + 1], ab[2], as[2]);
      split_tf32(s[4 * kk + 3], ab[3], as[3]);
      const float* vp = Vs + (8 * kk + 2 * t4) * LD + g;  // column 8n + g at vp + 8n
#pragma unroll
      for (int n0 = 0; n0 < DH / 8; n0 += 8)
        mma_3xtf32<8>(o + 4 * n0, ab, as, vp + 8 * n0, vp + LD + 8 * n0, 8);
    }
  };
  // a tile wholly in this warp's future changes nothing (p = 0, corr = 1),
  // and a warp whose rows all lie past T stores nothing
  auto visits = [&](int kv0) { return wrow < seq && !(causal && kv0 > wrow + 15); };
  // q * scale in f32, once, as the reference scales q (rows inside T)
  auto scale_q = [&]() {
    for (int e = threadIdx.x; e < min(ROWS, seq - q0) * DH; e += tf32_threads<DH>())
      Qs[(e / DH) * LD + e % DH] *= scale;
  };

  if constexpr (!CLUSTER) {
    load_rows_async<DH>(Qs, qb, sq.t, q0, ROWS, seq, dh);
    load_rows_async<DH>(Kb, kb, sk.t, 0, FK, seq, dh);
    load_rows_async<DH>(Vb, vb, sv.t, 0, FK, seq, dh);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) {  // the next tile into the other stage
        const int nx = (it + 1) & 1;
        load_rows_async<DH>(Kb + nx * FK * LD, kb, sk.t, (it + 1) * FK, FK, seq, dh);
        load_rows_async<DH>(Vb + nx * FK * LD, vb, sv.t, (it + 1) * FK, FK, seq, dh);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      if (it == 0) {
        scale_q();
        __syncthreads();
      }
      if (visits(it * FK)) {
        float s[FK / 2];
        scores(Kb + (it & 1) * FK * LD, s);
        absorb(s, Vb + (it & 1) * FK * LD, it * FK);
      }
      __syncthreads();  // the stage is refilled next
    }
  } else {
    // One K and one V tile of CK keys: K(it + 1) loads while the cluster
    // sums S(it) and runs its softmax, V(it + 1) while S(it + 1) is
    // computed.  Commit groups alternate K, V (possibly empty), so the
    // second newest is always the one waited for.
    float* Vc = Kb + CK * LD;
    const int ctiles = (kv_end + CK - 1) / CK;
    load_rows_async<DH>(Qs, qb, sq.t, q0, ROWS, seq, dh);
    load_rows_async<DH>(Kb, kb, sk.t, 0, CK, seq, dh);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    load_rows_async<DH>(Vc, vb, sv.t, 0, CK, seq, dh);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int it = 0; it < ctiles; ++it) {
      const int kv0 = it * CK;
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // K(it) (and Q)
      __syncthreads();
      if (it == 0) {
        scale_q();
        __syncthreads();
      }
      const bool visit = visits(kv0);
      float s[CK / 2];
      if (visit) scores(Kb, s);
      __syncthreads();  // K(it) is read
      if (it + 1 < ctiles) load_rows_async<DH>(Kb, kb, sk.t, kv0 + CK, CK, seq, dh);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (visit) cluster_sum(s, xs, lane);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // V(it)
      __syncthreads();
      if (visit) absorb(s, Vc, kv0);
      __syncthreads();  // V(it) is read
      if (it + 1 < ctiles) load_rows_async<DH>(Vc, vb, sv.t, kv0 + CK, CK, seq, dh);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= seq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = out + (((size_t)b * seq + row[r]) * heads + h) * ldo + col0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      if (8 * n >= dh) break;  // padding columns are not stored
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(o[4 * n + 2 * r] / den, o[4 * n + 2 * r + 1] / den);
    }
  }
  if constexpr (CLUSTER) cluster_drain(xs);
}

// ----------------------------------------------------------------------
// Launches of the tensor-core routes
// ----------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda at build time).
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The 4-D map of a bf16 (B, T, H, Dh) tensor with strides s (elements; Dh's
// is 1): dims innermost first (Dh, H, T, B) with the true Dh, box (64, 1,
// rows, 1), 128-byte swizzle; columns past Dh and rows past T read as zeros
// (FLOAT_OOB_FILL_NONE fills with zeros, not NaN).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int dh,
                     Strides s, int rows) {
  EncodeTiled fn;
  cudaError_t e = encode_tiled(&fn);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.t * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH, bool PAD>
int run_wgmma(const void* q, const void* k, const void* v, void* out, int batch, int seq,
              int heads, int dh, int causal, float scale, Strides sq, Strides sk, Strides sv,
              void* stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_map(&mq, q, batch, seq, heads, dh, sq, TQ)) != cudaSuccess) return (int)e;
  if ((e = make_map(&mk, k, batch, seq, heads, dh, sk, wg_keys<DH>())) != cudaSuccess) return (int)e;
  if ((e = make_map(&mv, v, batch, seq, heads, dh, sv, wg_keys<DH>())) != cudaSuccess) return (int)e;
  constexpr int smem = wg_smem_bytes<DH>();
  e = cudaFuncSetAttribute(flash_wgmma_kernel<DH, PAD, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(batch * heads, (seq + TQ - 1) / TQ);  // every head's longest tiles first
  flash_wgmma_kernel<DH, PAD, false><<<grid, WTHREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), heads, seq, dh, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH, bool PAD>
int run_tf32(const void* q, const void* k, const void* v, void* out, int batch, int seq,
             int heads, int dh, int causal, float scale, Strides sq, Strides sk, Strides sv,
             void* stream) {
  constexpr int smem = tf32_smem_bytes<DH>(), rows = tf32_rows<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_tf32_kernel<DH, PAD, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(batch * heads, (seq + rows - 1) / rows);  // every head's longest tiles first
  flash_tf32_kernel<DH, PAD, false><<<grid, tf32_threads<DH>(), smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), heads, seq, dh, causal, scale, sq, sk, sv);
  return (int)cudaGetLastError();
}

// The tile of a head dim (a multiple of 8, at most 256): the narrowest of
// 64, 128, 192 and 256 columns that holds it; a narrower Dh runs padded.
int tc_tile(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= 192 ? 192 : 256; }

using Launch = int (*)(const void*, const void*, const void*, void*, int, int, int, int, int,
                       float, Strides, Strides, Strides, void*);

// Run the instantiation of a tensor-core route for dh's tile: runs[tile / 64 - 1]
// [padded], after checking the route's contract.
int run_tc(const Launch (&runs)[4][2], const void* q, const void* k, const void* v, void* out,
           int batch, int seq, int heads, int dh, int causal, float scale, Strides sq,
           Strides sk, Strides sv, void* stream) {
  if (sq.d != 1 || sk.d != 1 || sv.d != 1) return (int)cudaErrorInvalidValue;
  if (dh < 8 || dh > 256 || dh % 8) return (int)cudaErrorInvalidValue;
  const int tile = tc_tile(dh);
  return runs[tile / 64 - 1][dh != tile](q, k, v, out, batch, seq, heads, dh, causal, scale, sq,
                                         sk, sv, stream);
}

// ----------------------------------------------------------------------
// Launches of the cluster route (padded Dh 264 .. CLUSTER_DH_MAX)
// ----------------------------------------------------------------------

// The cluster of a head dim past 256 (a multiple of 8, at most
// CLUSTER_DH_MAX): nc = ceil(dh / 256) CTAs, each holding an equal share of
// the columns rounded up to a multiple of 64.  That is 192 or 256:
// 256 (nc - 1) < dh <= 256 nc puts ceil(dh / nc) in (128, 256].  The last
// CTA holds at least 8 columns of Dh: (nc - 1) share <= 256 (nc - 1) < dh.
int cluster_ctas(int dh) { return (dh + 255) / 256; }
int cluster_share(int dh) {
  const int nc = cluster_ctas(dh);
  return ((dh + nc - 1) / nc + 63) / 64 * 64;
}

// Launch configuration of one cluster of nc CTAs along x.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, int nc, size_t smem, void* stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of nc CTAs of `kernel` the card holds at once, or an
// error: a cluster that cannot be placed is refused, never run some other
// way.  Asked once per device and size, then cached, so a launch adds no
// query.
constexpr int MAX_DEVICES = 16;
template <auto kernel>
cudaError_t cluster_room(int nc, int threads, int smem, int* clusters) {
  static std::atomic<int> known[MAX_DEVICES][MAX_CLUSTER + 1];  // clusters + 1; 0: not asked
  if (nc < 2 || nc > MAX_CLUSTER) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && known[dev][nc].load() > 0) {
    *clusters = known[dev][nc].load() - 1;
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (nc > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  ClusterLaunch l(dim3(nc), threads, nc, smem, nullptr);
  e = cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg);
  if (e != cudaSuccess) return e;
  if (*clusters <= 0) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEVICES) known[dev][nc].store(*clusters + 1);
  return cudaSuccess;
}

// bf16: flash_wgmma_kernel<share, false, true>, one cluster per (batch*head,
// 128-row query tile); the TMA maps carry the true Dh.
template <int DH>
cudaError_t wgmma_cluster_room(int dh, int* clusters) {
  return cluster_room<flash_wgmma_kernel<DH, false, true>>(cluster_ctas(dh), WTHREADS,
                                                            wg_smem_bytes<DH, true>(), clusters);
}
template <int DH>
int run_wgmma_cluster(const void* q, const void* k, const void* v, void* out, int batch, int seq,
                      int heads, int dh, int causal, float scale, Strides sq, Strides sk,
                      Strides sv, void* stream) {
  int room = 0;
  cudaError_t e = wgmma_cluster_room<DH>(dh, &room);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  if ((e = make_map(&mq, q, batch, seq, heads, dh, sq, TQ)) != cudaSuccess) return (int)e;
  if ((e = make_map(&mk, k, batch, seq, heads, dh, sk, wg_keys<DH>())) != cudaSuccess) return (int)e;
  if ((e = make_map(&mv, v, batch, seq, heads, dh, sv, wg_keys<DH>())) != cudaSuccess) return (int)e;
  const int nc = cluster_ctas(dh);
  ClusterLaunch l(dim3(batch * heads * nc, (seq + TQ - 1) / TQ), WTHREADS, nc,
                  wg_smem_bytes<DH, true>(), stream);
  e = cudaLaunchKernelEx(&l.cfg, flash_wgmma_kernel<DH, false, true>, mq, mk, mv,
                         static_cast<__nv_bfloat16*>(out), heads, seq, dh, causal, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// f32: flash_tf32_kernel<share, false, true>, one cluster per (batch*head,
// tf32_rows query rows).
template <int DH>
cudaError_t tf32_cluster_room(int dh, int* clusters) {
  return cluster_room<flash_tf32_kernel<DH, false, true>>(
      cluster_ctas(dh), tf32_threads<DH>(), tf32_smem_bytes<DH, true>(), clusters);
}
template <int DH>
int run_tf32_cluster(const void* q, const void* k, const void* v, void* out, int batch, int seq,
                     int heads, int dh, int causal, float scale, Strides sq, Strides sk,
                     Strides sv, void* stream) {
  int room = 0;
  cudaError_t e = tf32_cluster_room<DH>(dh, &room);
  if (e != cudaSuccess) return (int)e;
  const int nc = cluster_ctas(dh), rows = tf32_rows<DH>();
  ClusterLaunch l(dim3(batch * heads * nc, (seq + rows - 1) / rows), tf32_threads<DH>(), nc,
                  tf32_smem_bytes<DH, true>(), stream);
  e = cudaLaunchKernelEx(&l.cfg, flash_tf32_kernel<DH, false, true>, static_cast<const float*>(q),
                         static_cast<const float*>(k), static_cast<const float*>(v),
                         static_cast<float*>(out), heads, seq, dh, causal, scale, sq, sk, sv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

using Room = cudaError_t (*)(int, int*);

// The cluster route's contract (256 < dh <= CLUSTER_DH_MAX, a multiple of
// 8; innermost strides 1), then the instantiation of dh's share:
// runs[share == 256].
bool cluster_dh_ok(int dh) { return dh > 256 && dh <= CLUSTER_DH_MAX && dh % 8 == 0; }
int run_cluster(const Launch (&runs)[2], const void* q, const void* k, const void* v, void* out,
                int batch, int seq, int heads, int dh, int causal, float scale, Strides sq,
                Strides sk, Strides sv, void* stream) {
  if (sq.d != 1 || sk.d != 1 || sv.d != 1 || !cluster_dh_ok(dh)) return (int)cudaErrorInvalidValue;
  return runs[cluster_share(dh) == 256](q, k, v, out, batch, seq, heads, dh, causal, scale, sq, sk,
                                        sv, stream);
}
int room_cluster(const Room (&rooms)[2], int dh, int* ctas, int* clusters) {
  if (!cluster_dh_ok(dh)) return (int)cudaErrorInvalidValue;
  *ctas = cluster_ctas(dh);
  return (int)rooms[cluster_share(dh) == 256](dh, clusters);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (or
// the error that refused the launch).  Strides are in elements, in (B, T,
// H, Dh) order, for q, k and v; the output is contiguous (B, T, H, Dh).
//
// The CUDA-core kernel: f32 or bf16, Dh > 4096 in steps of 8 (anything else:
// cudaErrorInvalidValue), any strides.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int batch, int seq, int heads, int dh,
                        int causal, float scale, long long qb, long long qt,
                        long long qh, long long qd, long long kb, long long kt,
                        long long kh, long long kd, long long vb, long long vt,
                        long long vh, long long vd, void* stream) {
  return launch_flash<float>(q, k, v, out, batch, seq, heads, dh, causal,
                             scale, Strides{qb, qt, qh, qd},
                             Strides{kb, kt, kh, kd}, Strides{vb, vt, vh, vd},
                             stream);
}
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int batch, int seq, int heads, int dh,
                         int causal, float scale, long long qb, long long qt,
                         long long qh, long long qd, long long kb,
                         long long kt, long long kh, long long kd,
                         long long vb, long long vt, long long vh,
                         long long vd, void* stream) {
  return launch_flash<__nv_bfloat16>(
      q, k, v, out, batch, seq, heads, dh, causal, scale,
      Strides{qb, qt, qh, qd}, Strides{kb, kt, kh, kd},
      Strides{vb, vt, vh, vd}, stream);
}
// Tensor-core routes: 8 <= Dh <= 256 in steps of 8 (anything else:
// cudaErrorInvalidValue), run in a tile of 64, 128, 192 or 256 columns,
// padded when Dh is narrower; the innermost stride 1, the others multiples
// of 16 bytes, pointers 16-byte aligned (TMA's and cp.async's rule; the
// wrapper checks it).
int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* out, int batch,
                               int seq, int heads, int dh, int causal, float scale, long long qb,
                               long long qt, long long qh, long long qd, long long kb,
                               long long kt, long long kh, long long kd, long long vb,
                               long long vt, long long vh, long long vd, void* stream) {
  static const Launch runs[4][2] = {{run_wgmma<64, false>, run_wgmma<64, true>},
                                    {run_wgmma<128, false>, run_wgmma<128, true>},
                                    {run_wgmma<192, false>, run_wgmma<192, true>},
                                    {run_wgmma<256, false>, run_wgmma<256, true>}};
  return run_tc(runs, q, k, v, out, batch, seq, heads, dh, causal, scale, Strides{qb, qt, qh, qd},
                Strides{kb, kt, kh, kd}, Strides{vb, vt, vh, vd}, stream);
}
int flash_attention_3xtf32_f32(const void* q, const void* k, const void* v, void* out, int batch,
                               int seq, int heads, int dh, int causal, float scale, long long qb,
                               long long qt, long long qh, long long qd, long long kb,
                               long long kt, long long kh, long long kd, long long vb,
                               long long vt, long long vh, long long vd, void* stream) {
  static const Launch runs[4][2] = {{run_tf32<64, false>, run_tf32<64, true>},
                                    {run_tf32<128, false>, run_tf32<128, true>},
                                    {run_tf32<192, false>, run_tf32<192, true>},
                                    {run_tf32<256, false>, run_tf32<256, true>}};
  return run_tc(runs, q, k, v, out, batch, seq, heads, dh, causal, scale, Strides{qb, qt, qh, qd},
                Strides{kb, kt, kh, kd}, Strides{vb, vt, vh, vd}, stream);
}
// The cluster route: 256 < Dh <= 4096 in steps of 8 (anything else:
// cudaErrorInvalidValue), split over a cluster of ceil(Dh / 256) CTAs of
// 192 or 256 columns; strides and alignment as for the tensor-core routes.
int flash_attention_cluster_bf16(const void* q, const void* k, const void* v, void* out,
                                 int batch, int seq, int heads, int dh, int causal, float scale,
                                 long long qb, long long qt, long long qh, long long qd,
                                 long long kb, long long kt, long long kh, long long kd,
                                 long long vb, long long vt, long long vh, long long vd,
                                 void* stream) {
  static const Launch runs[2] = {run_wgmma_cluster<192>, run_wgmma_cluster<256>};
  return run_cluster(runs, q, k, v, out, batch, seq, heads, dh, causal, scale,
                     Strides{qb, qt, qh, qd}, Strides{kb, kt, kh, kd}, Strides{vb, vt, vh, vd},
                     stream);
}
int flash_attention_cluster_f32(const void* q, const void* k, const void* v, void* out, int batch,
                                int seq, int heads, int dh, int causal, float scale, long long qb,
                                long long qt, long long qh, long long qd, long long kb,
                                long long kt, long long kh, long long kd, long long vb,
                                long long vt, long long vh, long long vd, void* stream) {
  static const Launch runs[2] = {run_tf32_cluster<192>, run_tf32_cluster<256>};
  return run_cluster(runs, q, k, v, out, batch, seq, heads, dh, causal, scale,
                     Strides{qb, qt, qh, qd}, Strides{kb, kt, kh, kd}, Strides{vb, vt, vh, vd},
                     stream);
}
// The cluster route's shape for a padded Dh: CTAs per cluster and how many
// such clusters the card holds at once (the launch's own query; sets the
// kernel's attributes); launches nothing.  `stream` is unused.
int flash_cluster_room_bf16(int dh, int* ctas, int* clusters, void* stream) {
  static const Room rooms[2] = {wgmma_cluster_room<192>, wgmma_cluster_room<256>};
  return room_cluster(rooms, dh, ctas, clusters);
}
int flash_cluster_room_f32(int dh, int* ctas, int* clusters, void* stream) {
  static const Room rooms[2] = {tf32_cluster_room<192>, tf32_cluster_room<256>};
  return room_cluster(rooms, dh, ctas, clusters);
}

}  // extern "C"
