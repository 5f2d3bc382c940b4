// Causal GQA prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel).  One block computes one (batch, query head, 64-query
// tile).  It walks the key tiles the tile can see (causal: up to its last
// query; with a window: from its first query's window start), keeping the
// f32 row max, row sum and 64 x hd accumulator in registers: the loop over
// key tiles takes the place of the TPU grid's sequential KV axis.  K and V
// tiles are staged in shared memory as f32; the query head reads the KV
// head h / (H / KV), so K and V are never repeated in memory.
//
// Thread layout (256 threads): thread t owns query rows 4*(t/16) .. +3.
// For the scores it owns key columns t%16 + 16*j (j < 4) of those rows; for
// the accumulator it owns head dims t%16 + 16*j (j < hd/16).  The 16 threads
// of a row group are one half warp, so the row max and sum are shuffles and
// the probability tile needs only __syncwarp before the PV product.
//
// Masking follows the reference: inside the sequence a masked score is
// -1e30, so a tile that is wholly masked for a row is wiped by the rescale
// exp(-1e30 - m) == 0 once that row meets its first visible key; slots past
// the end of the sequence (the ragged tail of the last tile) score -inf and
// add nothing.  The final division guards l == 0 as the reference does.
#include <stdint.h>

#include "common.cuh"

namespace {

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
             T* __restrict__ o, int S, int H, int KV, float scale, int causal, int window) {
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
  const T* qb = q + (int64_t)b * S * q_stride + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * S * kv_stride + (int64_t)kvh * HD;
  const T* vb = v + (int64_t)b * S * kv_stride + (int64_t)kvh * HD;
  T* ob = o + (int64_t)b * S * q_stride + (int64_t)h * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    sq[r * LD + d] = q0 + r < S ? to_float(qb[(q0 + r) * q_stride + d]) : 0.f;
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

  int k_begin = 0, k_end = S;
  if (causal) {
    k_end = min(S, q0 + BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < S;
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
        if (ki >= S) {
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
    if (qi >= S) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[qi * q_stride + ln + 16 * j] = from_float<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KV, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                     int KV, int HD, float scale, int causal, int window, cudaStream_t stream) {
  switch (HD) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, causal, window, stream);
    case 96: return launch<T, 96>(q, k, v, o, B, S, H, KV, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes (0 for an unsupported HD).
extern "C" int repro_flash_attention_smem_bytes(int HD) {
  switch (HD) {
    case 32: return smem_floats<32>() * (int)sizeof(float);
    case 64: return smem_floats<64>() * (int)sizeof(float);
    case 96: return smem_floats<96>() * (int)sizeof(float);
    case 128: return smem_floats<128>() * (int)sizeof(float);
    default: return 0;
  }
}

// q, o: (B, S, H, HD); k, v: (B, S, KV, HD); all contiguous, on the current
// device.  window <= 0 means no window.  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int S, int H, int KV, int HD, int is_bf16, float scale,
                                     int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, HD, scale, causal, window, st)
      : dispatch<float>(q, k, v, o, B, S, H, KV, HD, scale, causal, window, st);
  return (int)err;
}
