// One-token decode attention over a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (_decode_kernel).  One block serves one (batch, KV head) with its whole
// GQA group of query heads resident, so each cache slot is read from device
// memory once per step, as on the TPU.  A loop over 64-slot tiles takes the
// place of the TPU grid's sequential cache axis; the f32 row max, row sum
// and group x hd accumulator live in shared memory, each accumulator element
// owned by one thread.
//
// Masking follows the reference: a slot at or past lengths[b] scores -1e30.
// Once a row has met a valid slot, such a slot adds exp(-1e30 - m) == 0, and
// the valid slots come first, so the block reads only the first
// min(lengths[b], L) slots.  With lengths[b] == 0 every slot scores -1e30
// and weighs the same, so the block reads all L and returns the mean of V,
// as ref.decode_attention_ref does.  Slots past L (the ragged tail of the
// last tile) score -inf and add nothing.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BK = 64;
constexpr int NT = 128;
constexpr int NW = NT / 32;

template <int HD>
int smem_floats(int G) {
  return G * (HD + 1) + BK * (HD + 1) + BK * HD + G * (BK + 1) + G * HD + 3 * G;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ lengths, T* __restrict__ o, int L, int H, int KV,
              float scale) {
  using namespace repro;
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  const int G = H / KV;
  extern __shared__ float smem[];
  float* sq = smem;              // G x LD
  float* sk = sq + G * LD;       // BK x LD
  float* sv = sk + BK * LD;      // BK x HD
  float* sp = sv + BK * HD;      // G x LP: scores, then probabilities
  float* sacc = sp + G * LP;     // G x HD
  float* sm = sacc + G * HD;     // G: running max
  float* sl = sm + G;            // G: running sum
  float* sa = sl + G;            // G: this tile's rescale factor

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int len = lengths[b];
  const int n = len > 0 ? min(len, L) : L;

  const int64_t row = (int64_t)KV * HD;   // one cache slot
  const T* qb = q + ((int64_t)b * H + (int64_t)g * G) * HD;
  const T* kb = kc + (int64_t)b * L * row + (int64_t)g * HD;
  const T* vb = vc + (int64_t)b * L * row + (int64_t)g * HD;
  T* ob = o + ((int64_t)b * H + (int64_t)g * G) * HD;

  for (int e = tid; e < G * HD; e += NT) {
    sq[(e / HD) * LD + e % HD] = to_float(qb[e]);
    sacc[e] = 0.f;
  }
  for (int r = tid; r < G; r += NT) {
    sm[r] = kMasked;
    sl[r] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BK * HD; e += NT) {
      const int c = e / HD, d = e % HD;
      const bool in = k0 + c < n;
      sk[c * LD + d] = in ? to_float(kb[(k0 + c) * row + d]) : 0.f;
      sv[c * HD + d] = in ? to_float(vb[(k0 + c) * row + d]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < G * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int slot = k0 + c;
      float x = -INFINITY;
      if (slot < n) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(sq[r * LD + d], sk[c * LD + d], dot);
        x = slot < len ? dot * scale : kMasked;
      }
      sp[r * LP + c] = x;
    }
    __syncthreads();

    for (int r = warp; r < G; r += NW) {
      const float x0 = sp[r * LP + lane];
      const float x1 = sp[r * LP + lane + 32];
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, group_max<32>(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      const float sum = group_sum<32>(p0 + p1);
      sp[r * LP + lane] = round_to<T>(p0);
      sp[r * LP + lane + 32] = round_to<T>(p1);
      __syncwarp();  // every lane has read sm[r]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sa[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      float a = sacc[e] * sa[r];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) a = fmaf(sp[r * LP + c], sv[c * HD + d], a);
      sacc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * HD; e += NT) {
    const float l = sl[e / HD];
    ob[e] = from_float<T>(sacc[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* lengths, void* o,
                   int B, int L, int H, int KV, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<HD>(H / KV) * (int)sizeof(float);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  dim3 grid(KV, B);
  decode_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      static_cast<T*>(o), L, H, KV, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kc, const void* vc, const int* lengths, void* o,
                     int B, int L, int H, int KV, int HD, float scale, cudaStream_t stream) {
  switch (HD) {
    case 32: return launch<T, 32>(q, kc, vc, lengths, o, B, L, H, KV, scale, stream);
    case 64: return launch<T, 64>(q, kc, vc, lengths, o, B, L, H, KV, scale, stream);
    case 96: return launch<T, 96>(q, kc, vc, lengths, o, B, L, H, KV, scale, stream);
    case 128: return launch<T, 128>(q, kc, vc, lengths, o, B, L, H, KV, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block for a GQA group of G heads, in bytes
// (0 for an unsupported HD).
extern "C" int repro_decode_attention_smem_bytes(int G, int HD) {
  switch (HD) {
    case 32: return smem_floats<32>(G) * (int)sizeof(float);
    case 64: return smem_floats<64>(G) * (int)sizeof(float);
    case 96: return smem_floats<96>(G) * (int)sizeof(float);
    case 128: return smem_floats<128>(G) * (int)sizeof(float);
    default: return 0;
  }
}

// q, o: (B, H, HD); k_cache, v_cache: (B, L, KV, HD); lengths: (B,) int32;
// all contiguous, on the current device.  Returns the launch's cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const void* lengths, void* o, int B, int L, int H, int KV,
                                      int HD, int is_bf16, float scale, void* stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(q, k_cache, v_cache, len, o, B, L, H, KV, HD, scale, st)
      : dispatch<float>(q, k_cache, v_cache, len, o, B, L, H, KV, HD, scale, st);
  return (int)err;
}
