// Forward flash attention (online softmax), written by hand for Hopper
// (sm_90a).  Plain C entry points, built with the other csrc sources by
// repro_torch/kernels/_build.py and called from
// repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py:
//   flash_fwd_kernel  <- flash_attention (:77) / _flash_body (:31)
//
// What it computes (as the TPU kernel does): for Q, K, V of shape
// (B, T, H, Dh), K and V already repeated to the query head count,
//   O = softmax(scale * Q K^T [causal: key <= query, else -1e30]) V,
// scale = Dh^-0.5 applied to q in f32, every product and the running
// (max, sum, accumulator) in f32, the final division by max(l, 1e-30), one
// rounding to the input type (f32 or bf16) on the store.  No logsumexp, no
// backward pass.
//
// Design.  On the TPU the KV grid axis runs in order and carries the running
// state in VMEM scratch between grid steps.  Blocks on Hopper run in no
// order, so here one CTA owns one (batch*head, 64-row query tile) and loops
// over the 64-key KV tiles itself:
//   * the query tile (pre-scaled), one K tile, one V tile and the 64x64
//     probability tile live in dynamic shared memory as f32, rows padded to
//     Dh+1 / 65 floats so the column reads of the two products do not
//     conflict (Dh=128: 113 KB, Dh=256: 209 KB, opted in with
//     cudaFuncSetAttribute);
//   * 256 threads as 16x16: thread (tx, ty) owns rows ty+16i (i<4), score
//     columns tx+16j (j<4) and output columns tx+16c; a row's max and sum
//     are reduced over the 16 lanes sharing ty by warp shuffles, and the
//     row's m, l and accumulator stay in registers;
//   * tensors are read through their (B, T, H, Dh) strides: no transposed
//     copies; the output is written contiguous (B, T, H, Dh);
//   * causal: KV tiles wholly in the future are not visited, and query tiles
//     are scheduled longest first; keys past T (the ragged last tile, when
//     64 does not divide T) get probability 0, query rows past T are not
//     stored.
// What bounds it on this card: operations.  At the main-path shape
// (B=2, T=4096, H=32, Dh=128, causal) it does ~2.75e11 flops while moving
// ~537 MB (f32: q, k, v read once, o written once), ~510 flops per byte,
// far above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s: 20);
// with every product on the CUDA cores in f32 the bound is the f32 rate
// (67 TFLOP/s).  This first version reads both operands of every FMA from
// shared memory, so it runs well below that; tensor cores (wgmma on bf16,
// TMA-fed KV tiles) are a later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // query rows per CTA
constexpr int BKV = 64;   // keys per KV tile
constexpr int NT = 256;   // threads per CTA (16 x 16)
constexpr int PLD = BKV + 1;  // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

struct Strides {
  long long b, t, h, d;
};

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

// Copy rows [r0, r0 + rows) of one (batch, head)'s (T, Dh) slice into a
// (rows x ld) f32 tile, times `mul`; rows past T are zero.
template <typename Elem>
__device__ void load_tile(const Elem* base, Strides s, int r0, int rows,
                          int seq, int dh, int ld, float mul, float* tile) {
  for (int e = threadIdx.x; e < rows * dh; e += NT) {
    const int r = e / dh, d = e - r * dh;
    const int t = r0 + r;
    tile[r * ld + d] = t < seq ? to_f32(base[t * s.t + d * s.d]) * mul : 0.f;
  }
}

// NC: 16-wide column chunks of Dh a thread's accumulator covers
// (Dh <= 16 * NC).
template <typename Elem, int NC>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                     const Elem* __restrict__ v, Elem* __restrict__ out,
                     int heads, int seq, int dh, int causal, float scale,
                     Strides sq, Strides sk, Strides sv) {
  extern __shared__ __align__(16) float smem[];
  const int ld = dh + 1;
  float* Qs = smem;            // BQ  x ld
  float* Ks = Qs + BQ * ld;    // BKV x ld
  float* Vs = Ks + BKV * ld;   // BKV x ld
  float* Ps = Vs + BKV * ld;   // BQ  x PLD

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const float neg_inf_f32 = __int_as_float(0xff800000);

  load_tile(q + b * sq.b + h * sq.h, sq, q0, BQ, seq, dh, ld, scale, Qs);
  const Elem* kb = k + b * sk.b + h * sk.h;
  const Elem* vb = v + b * sv.b + h * sv.h;

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
    load_tile(kb, sk, kv0, BKV, seq, dh, ld, 1.f, Ks);
    load_tile(vb, sv, kv0, BKV, seq, dh, ld, 1.f, Vs);
    __syncthreads();

    // S = (scale Q) K^T for the thread's 4 x 4 entries
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
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

    // acc += P V
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < dh ? Vs[j * ld + d] : 0.f;
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
    Elem* o = out + (((long long)b * seq + t) * heads + h) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) o[d] = from_f32<Elem>(acc[i][c] / den);
    }
  }
}

template <typename Elem, int NC>
int run_flash(const void* q, const void* k, const void* v, void* out,
              int batch, int seq, int heads, int dh, int causal, float scale,
              Strides sq, Strides sk, Strides sv, void* stream) {
  const size_t smem =
      ((size_t)(BQ + 2 * BKV) * (dh + 1) + (size_t)BQ * PLD) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<Elem, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  flash_fwd_kernel<Elem, NC><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(out), heads, seq, dh,
      causal, scale, sq, sk, sv);
  return (int)cudaGetLastError();
}

template <typename Elem>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int batch, int seq, int heads, int dh, int causal,
                 float scale, Strides sq, Strides sk, Strides sv,
                 void* stream) {
  // the wrapper admits 8 <= Dh <= 256 in steps of 8
  if (dh <= 16)
    return run_flash<Elem, 1>(q, k, v, out, batch, seq, heads, dh, causal,
                              scale, sq, sk, sv, stream);
  if (dh <= 32)
    return run_flash<Elem, 2>(q, k, v, out, batch, seq, heads, dh, causal,
                              scale, sq, sk, sv, stream);
  if (dh <= 64)
    return run_flash<Elem, 4>(q, k, v, out, batch, seq, heads, dh, causal,
                              scale, sq, sk, sv, stream);
  if (dh <= 128)
    return run_flash<Elem, 8>(q, k, v, out, batch, seq, heads, dh, causal,
                              scale, sq, sk, sv, stream);
  return run_flash<Elem, 16>(q, k, v, out, batch, seq, heads, dh, causal,
                             scale, sq, sk, sv, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
// Strides are in elements, in (B, T, H, Dh) order, for q, k and v.
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

}  // extern "C"
