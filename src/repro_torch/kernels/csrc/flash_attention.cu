// GQA prefill attention for Hopper (sm_90a): causal, windowed or not, with
// Sq queries over Sk keys (Sq != Sk allowed, as the TPU kernel allows it).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  One block computes one (batch, query
// head, query tile) and walks the key tiles the tile can see (causal: up to
// its last query; with a window: from its first query's window start),
// keeping the row max, row sum and the tile's hd-wide accumulator in f32
// registers: the loop over key tiles takes the place of the TPU grid's
// sequential KV axis.
// The query head reads the KV head h / (H / KV), so K and V are never
// repeated in memory.
//
// What bounds it on an H100: at the decoders' prompt lengths (S 8 to 512)
// the bytes of Q, K, V and O (the work is about S / 4 FLOPs a byte in bf16,
// the card's ridge about 295); above S of about 1200 the tensor cores' rate
// (whisper's non-causal encoder at S 1500: S / 2 FLOPs a byte).  A few
// queries over many keys (whisper's cross-attention prefill, Sq 32 over Sk
// 1500) read K and V once a query tile, and their bytes bound it.  Two
// kernels, chosen by dtype:
//
// * bf16 (the serving path), flash_tc_kernel: FlashAttention-2's design.
//   A block owns 128 query rows and eight warps, each warp 16 rows.  Both
//   products run on the tensor cores, mma.sync m16n8k16 bf16 -> f32:
//   S = Q K^T with the Q fragments read from shared memory by ldmatrix,
//   then the f32 accumulator fragment of S is scaled, masked and
//   exponentiated in registers, rounded to bf16 (the reference's
//   p.astype(v.dtype)) and fed straight back as the A operand of O += P V,
//   with V read through ldmatrix.trans.  The row max and row sum (summed
//   from the f32 probabilities before rounding) are quad shuffles.  K and V
//   tiles stay bf16 in shared memory, rows padded by 16 bytes so that
//   ldmatrix is free of bank conflicts at every head dim (96 included), and
//   arrive by cp.async into a two-stage ring: the loads of tile t+1 run
//   under the products of tile t.  Each K/V tile serves 128 queries, which
//   halves the K/V traffic of 64-row tiles; about 102 KB of shared memory
//   a block at hd 128 and 78 KB at hd 96, and at most 128 registers a
//   thread, so two blocks (16 warps) share an SM.  A warp skips a tile
//   that hides every key from its rows; the element mask is applied only
//   on a tile that crosses the diagonal, the window's edge or the end of
//   the sequence.  Query tiles are issued longest first.
// * f32 (the reduced families the profiler measures, and the f32 parity
//   checks), flash_kernel: products on the f32 CUDA cores from f32 tiles in
//   shared memory, so f32 inputs are never rounded to TF32 and hold the
//   reference's f32 tolerance of 2e-4.
//
// Masking follows the reference: positions count from 0 on both sides, so
// the causal mask keeps k_pos <= q_pos (top-left aligned); inside the keys a
// masked score is -1e30, so a tile that is wholly masked for a row is wiped
// by the rescale exp(-1e30 - m) == 0 once that row meets its first visible
// key; slots past the last key (the ragged tail of the last tile) score -inf
// and add nothing.  A causal row with a window can see no key at all when
// q_pos >= Sk + window - 1 (only where Sq > Sk): the reference then weighs
// every key alike (all scores -1e30), so a block holding such a row walks
// every key tile from 0.  The final division guards l == 0 as the reference
// does.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// The keys [*k_begin, *k_end) that the query rows [q0, q0 + rows) can see.
// Returns whether the key tiles before every row's window may be skipped:
// not where a row of the tile sees no key at all (q_pos >= Sk + window - 1),
// because the reference then weighs every key alike.
__device__ __forceinline__ bool key_range(int q0, int rows, int Sq, int Sk, int causal,
                                          int window, int* k_begin, int* k_end) {
  *k_begin = 0;
  *k_end = Sk;
  if (!causal) return false;
  *k_end = min(Sk, q0 + rows);
  const bool skip = window > 0 && min(q0 + rows, Sq) - 1 < Sk + window - 1;
  if (skip) *k_begin = max(0, q0 - window + 1);
  return skip;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core products.  Thread layout (256 threads): thread t owns query
// rows 4*(t/16) .. +3.  For the scores it owns key columns t%16 + 16*j
// (j < 4) of those rows; for the accumulator it owns head dims t%16 + 16*j
// (j < hd/16).  The 16 threads of a row group are one half warp, so the row
// max and sum are shuffles and the probability tile needs only __syncwarp
// before the PV product.
// ---------------------------------------------------------------------------
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Sq, int Sk, int H, int KV, float scale, int causal,
             int window) {
  using namespace repro;
  constexpr int LD = HD + 1;   // padded rows: the 16 lanes of a half warp hit 16 banks
  constexpr int LP = BK + 1;
  constexpr int DPT = HD / 16;
  extern __shared__ float smem[];
  float* sq = smem;            // BQ x LD
  float* sk = sq + BQ * LD;    // BK x LD
  float* sv = sk + BK * LD;    // BK x LD
  float* sp = sv + BK * LD;    // BQ x LP, probabilities of this tile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4;
  const int ln = tid % 16;

  const int64_t q_stride = (int64_t)H * HD;     // one sequence position of q / o
  const int64_t kv_stride = (int64_t)KV * HD;   // one sequence position of k / v
  const T* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * HD;
  const T* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * HD;
  T* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    sq[r * LD + d] = q0 + r < Sq ? to_float(qb[(q0 + r) * q_stride + d]) : 0.f;
  }

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, BQ, Sq, Sk, causal, window, &k_begin, &k_end);

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Sk;
      sk[r * LD + d] = in ? to_float(kb[(k0 + r) * kv_stride + d]) : 0.f;
      sv[r * LD + d] = in ? to_float(vb[(k0 + r) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sk[(ln + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + r0 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + ln + 16 * j;
        float x;
        if (ki >= Sk) {
          x = -INFINITY;
        } else {
          x = s[i][j] * scale;
          if (causal) {
            bool ok = ki <= qi;
            if (window > 0) ok = ok && ki > qi - window;
            if (!ok) x = kMasked;
          }
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sp[(r0 + i) * LP + ln + 16 * j] = round_to<T>(p);
      }
      sum = group_sum<16>(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // the row group's probabilities are written by its own half warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float va[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) va[j] = sv[c * LD + ln + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(r0 + i) * LP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, va[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[qi * q_stride + ln + 16 * j] = from_float<T>(acc[i][j] / den);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products (FlashAttention-2).  256 threads; warp w owns
// query rows 16w .. 16w+15 of the block's 128-row tile, so every K/V tile
// brought into shared memory serves 128 queries.
// ---------------------------------------------------------------------------
constexpr int TC_BQ = 128;
constexpr int TC_NT = 256;

template <int HD>
constexpr int tc_smem_bytes() {   // Q tile + a two-stage ring of K and V tiles
  return (TC_BQ + 4 * BK) * (HD + 8) * (int)sizeof(__nv_bfloat16);
}

// Copy ROWS rows of HD bf16 (row stride `stride` elements in device memory)
// into shared rows of LD; rows at or past S (the rows of src) are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void tc_load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             int64_t stride, int row0, int S) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;   // 16-byte pieces a row
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * CPR; e += TC_NT) {
    const int r = e / CPR, c = e % CPR;
    const bool in = row0 + r < S;
    repro::cp_async16(dst + r * LD + c * 8, in ? src + (row0 + r) * stride + c * 8 : src, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_NT, 2)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                int Sk, int H, int KV, float scale_log2, int causal, int window) {
  using namespace repro;
  constexpr int LD = HD + 8;   // 16-byte pad: the 8 rows of an ldmatrix tile hit 8 bank groups
  constexpr int KS = HD / 16;  // k-steps of Q K^T; also 16-wide column pairs of P V
  constexpr int DT = HD / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + TC_BQ * LD;    // two stages of BK x LD
  __nv_bfloat16* sv = sk + 2 * BK * LD;   // two stages of BK x LD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;   // the longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)KV * HD;
  const __nv_bfloat16* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * HD;
  const __nv_bfloat16* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * HD;
  const __nv_bfloat16* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * HD;
  __nv_bfloat16* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * HD;

  int k_begin, k_end;
  const bool skip_before_window =
      key_range(q0, TC_BQ, Sq, Sk, causal, window, &k_begin, &k_end);
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  tc_load_rows<HD, TC_BQ>(sq, qb, q_stride, q0, Sq);
  tc_load_rows<HD, BK>(sk, kb, kv_stride, t_begin * BK, Sk);
  tc_load_rows<HD, BK>(sv, vb, kv_stride, t_begin * BK, Sk);
  cp_async_commit();

  const int qw = q0 + warp * 16;             // the warp's first query row
  const int qr[2] = {qw + g, qw + g + 8};    // the rows of this thread's c0,c1 and c2,c3
  float acc[DT][4];
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int it = t_begin; it < t_end; ++it) {
    const int stage = (it - t_begin) & 1;
    if (it + 1 < t_end) {   // the next tile streams in under this tile's products
      tc_load_rows<HD, BK>(sk + (stage ^ 1) * BK * LD, kb, kv_stride, (it + 1) * BK, Sk);
      tc_load_rows<HD, BK>(sv + (stage ^ 1) * BK * LD, vb, kv_stride, (it + 1) * BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * BK;
    // a tile that hides every key from the warp's rows (past the diagonal,
    // before the window, or rows past Sq) adds nothing to them: skip it
    if (qw < Sq && !(causal && (k0 > qw + 15
                                || (skip_before_window && k0 + BK - 1 <= qw - window)))) {
      const __nv_bfloat16* ks_ = sk + stage * BK * LD;
      const __nv_bfloat16* vs_ = sv + stage * BK * LD;

      // S = Q K^T: 16 rows x 64 keys a warp, as 8 accumulator tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4];   // Q stays in shared memory: registers go to occupancy
        ldmatrix_x4(qf, sq + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16
                            + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, ks_ + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16
                             + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], qf, r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf, r[2], r[3]);
        }
      }

      // scale into the log2 domain; mask only a tile that crosses the
      // diagonal, the window's edge or the last key
      const bool edge = k0 + BK > Sk
          || (causal && (k0 + BK - 1 > qw || (window > 0 && k0 <= qw + 15 - window)));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int ki = k0 + 8 * j + 2 * t + (e & 1);
            const int qi = qr[e / 2];
            if (ki >= Sk) x = -INFINITY;
            else if (causal && (ki > qi || (window > 0 && ki <= qi - window))) x = kMasked;
          }
          s[j][e] = x;
        }

      // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3), one quad a row
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = group_max<4>(mx[r]);
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - mn);
        m[r] = mn;
      }
      // P as the A operand of P V: key step kk covers accumulator tiles 2kk, 2kk+1
      uint32_t pf[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
        const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
        sum[0] += p0 + p1;
        sum[1] += p2 + p3;
        pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + group_sum<4>(sum[r]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }

      // O += P V, V read transposed from its row-major tile
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vs_ + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD
                                   + dp * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * dp], pf[kk], r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], pf[kk], r[2], r[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qr[r] >= Sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* orow = ob + qr[r] * q_stride + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(orow + 8 * d) =
          pack_bf16(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KV, float scale, int causal, int window,
                       cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static cudaError_t configured = allow_smem(flash_kernel<float, HD>, bytes);
  if (configured != cudaSuccess) return configured;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<float, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, KV, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, int KV, float scale, int causal, int window,
                        cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<HD>();
  static cudaError_t configured = allow_smem(flash_tc_kernel<HD>, bytes);
  if (configured != cudaSuccess) return configured;
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  flash_tc_kernel<HD><<<grid, TC_NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV,
      scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

// Dynamic shared memory of one block and resident blocks per SM.
template <int HD>
int smem_bytes(int is_bf16) {
  return is_bf16 ? tc_smem_bytes<HD>() : smem_floats<HD>() * (int)sizeof(float);
}

template <int HD>
int blocks_per_sm(int is_bf16) {
  int n = 0;
  cudaError_t err;
  if (is_bf16) {
    err = allow_smem(flash_tc_kernel<HD>, tc_smem_bytes<HD>());
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_tc_kernel<HD>, TC_NT,
                                                          tc_smem_bytes<HD>());
  } else {
    const int bytes = smem_floats<HD>() * (int)sizeof(float);
    err = allow_smem(flash_kernel<float, HD>, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_kernel<float, HD>, NT, bytes);
  }
  return err == cudaSuccess ? n : -(int)err;
}

#define REPRO_FLASH_HEAD_DIMS(F, ...) \
  case 32: return F<32>(__VA_ARGS__);  \
  case 64: return F<64>(__VA_ARGS__);  \
  case 96: return F<96>(__VA_ARGS__);  \
  case 128: return F<128>(__VA_ARGS__);

}  // namespace

// Dynamic shared memory of one block, in bytes (0 for an unsupported HD).
extern "C" int repro_flash_attention_smem_bytes(int HD, int is_bf16) {
  switch (HD) {
    REPRO_FLASH_HEAD_DIMS(smem_bytes, is_bf16)
    default: return 0;
  }
}

// Resident blocks per SM of the kernel for (HD, dtype), from the occupancy
// calculator; a negative value is a cudaError_t.
extern "C" int repro_flash_attention_blocks_per_sm(int HD, int is_bf16) {
  switch (HD) {
    REPRO_FLASH_HEAD_DIMS(blocks_per_sm, is_bf16)
    default: return 0;
  }
}

// q, o: (B, Sq, H, HD); k, v: (B, Sk, KV, HD); all contiguous, on the
// current device, and (bf16) 16-byte aligned.  window <= 0 means no window.
// bf16 goes to the tensor-core kernel, f32 to the CUDA-core kernel.  Returns
// the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int Sq, int Sk, int H, int KV, int HD, int is_bf16,
                                     float scale, int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (HD) {
      REPRO_FLASH_HEAD_DIMS(launch_bf16, q, k, v, o, B, Sq, Sk, H, KV, scale, causal, window, st)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (HD) {
    REPRO_FLASH_HEAD_DIMS(launch_f32, q, k, v, o, B, Sq, Sk, H, KV, scale, causal, window, st)
    default: return (int)cudaErrorInvalidValue;
  }
}
