// The Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (_ssd_kernel).
// The TPU walks a grid (B, H, chunks) whose chunk axis runs in order and
// carries the (P, N) state in VMEM scratch between grid steps.  On Hopper
// blocks run in no order, so one block owns one (batch, head) and loops over
// the chunks itself, with the f32 state in shared memory (P x N, 32 KB at
// P 64, N 128).  Per chunk of `chunk` rows, with cum = cumsum(dt * a):
//
//   y[i]   = exp(cum_i) * C_i . state^T                      (inter-chunk)
//          + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j dt_j   (intra)
//   state <- state * exp(cum_last) + sum_j (x_j dt_j exp(cum_last - cum_j)) B_j^T
//
// everything in f32, as the TPU kernel computes it; y is written in x's
// type and the final state in f32.  The chunk's rows are cut into tiles of
// T = min(chunk, 64) rows: a row tile's C and a column tile's B are kept
// transposed in shared memory, and the 256 threads, as a 16 x 16 grid, each
// compute a 4 x 4 (or, for the state, 4 x 8) block of every product.  Only
// column tiles at or before the row tile are visited (the lower triangle).
//
// Every decay exponent is summed directly over its own segment, never taken
// as a difference of two prefix sums: over a 256-row chunk the prefix sums
// reach thousands, and a difference of two of them keeps only a few 1e-4 of
// absolute precision.  So exp(cum_i - cum_j) is exp(G_i + H_j) for a column
// tile before the row tile (G_i: da summed from the row tile's first row to
// i; H_j: da summed over (j, row tile)), a running sum down each column
// within the diagonal tile, and exp(cum_last - cum_j) a suffix scan.  Each
// partial sum adds terms of one sign (da <= 0).  The plain version sums the
// same segments (segsum in ssd_scan.py).
//
// The upper triangle (i < j) would overflow exp, so it is never computed: a
// score there is set to 0, not multiplied by a 0/1 mask.  Rows past S (the
// ragged last chunk) load as x = 0, dt = 0, B = C = 0: decay 1 and no
// contribution, so cum_last is the cum of the last valid row, as the zero
// padding of the reference gives; nothing is written past S.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads: a 16 x 16 grid
constexpr int TM = 64;         // rows of a tile, at most
constexpr int LD = TM + 1;     // padded row of a shared tile
constexpr int NMAX = 128;      // d_state, at most
constexpr int PMAX = 64;       // head_dim, at most
constexpr int CMAX = 256;      // chunk, at most
// st, ct, bt: NMAX x LD; xs, ss: TM x LD; da, cum, wd, hs: CMAX; gs: TM;
// wsum: NT / 32
constexpr int SMEM_FLOATS = 3 * NMAX * LD + 2 * TM * LD + 4 * CMAX + TM + NT / 32;

// Inclusive scan of v over the block's threads, in thread order.  Every
// thread must call it; wsum is free again when it returns.
__device__ __forceinline__ float block_scan(float v, float* wsum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  __syncthreads();
  return v + before;
}

// dst[n * LD + i] = src row (row0 + i), column n, for i < rows (0 past them)
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int row0, int rows,
                                                int T_, int64_t stride, int N) {
  for (int e = threadIdx.x; e < T_ * N; e += NT) {
    const int i = e / N, n = e % N;
    dst[n * LD + i] = i < rows ? repro::to_float(src[(int64_t)(row0 + i) * stride + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a_neg,
           const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ sf, int S, int H, int G, int P, int N,
           int chunk) {
  using namespace repro;
  extern __shared__ float smem[];
  float* st = smem;               // state, transposed: st[n * LD + p]
  float* ct = st + NMAX * LD;     // C of the row tile: ct[n * LD + i]
  float* bt = ct + NMAX * LD;     // B of the column tile: bt[n * LD + j]
  float* xs = bt + NMAX * LD;     // x * dt of the column tile: xs[j * LD + p]
  float* ss = xs + TM * LD;       // decays, then decayed scores: ss[i * LD + j]
  float* da = ss + TM * LD;       // dt * a over the chunk (0 past S)
  float* cum = da + CMAX;         // inclusive cumsum of da from the chunk's start
  float* wd = cum + CMAX;         // exp(sum of da over (j, chunk end))
  float* hs = wd + CMAX;          // H_j: sum of da over (j, row tile start)
  float* gs = hs + CMAX;          // G_i: sum of da over [row tile start, i]
  float* wsum = gs + TM;          // per-warp totals of a block scan

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int T_ = min(chunk, TM);
  const float a = a_neg[h];

  const int64_t xrow = (int64_t)H * P;   // x, y: (B, S, H, P)
  const int64_t brow = (int64_t)G * N;   // B, C: (B, S, G, N)
  const T* xb = x + (int64_t)b * S * xrow + (int64_t)h * P;
  T* yb = y + (int64_t)b * S * xrow + (int64_t)h * P;
  const float* dtb = dt + (int64_t)b * S * H + h;
  const T* bb = bm + (int64_t)b * S * brow + (int64_t)g * N;
  const T* cb = cm + (int64_t)b * S * brow + (int64_t)g * N;
  const int64_t so = ((int64_t)b * H + h) * P * N;   // state: (B, H, P, N)

  for (int e = tid; e < P * N; e += NT) st[(e % N) * LD + e / N] = s0 ? s0[so + e] : 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int rows = min(chunk, S - c0);
    const int ntiles = (rows + T_ - 1) / T_;
    __syncthreads();  // the previous chunk no longer reads da, cum, wd

    // chunk <= NT: one row a thread
    const float dav = tid < rows ? dtb[(int64_t)(c0 + tid) * H] * a : 0.f;
    if (tid < chunk) da[tid] = dav;
    const float cv = block_scan(dav, wsum);
    if (tid < chunk) cum[tid] = cv;
    // thread t sums da over the last t rows, (chunk - 1 - t, chunk)
    const float sv = block_scan(tid >= 1 && tid < chunk ? da[chunk - tid] : 0.f, wsum);
    if (tid < chunk) wd[chunk - 1 - tid] = expf(sv);
    const float cl = cum[rows - 1];   // rows past S add 0

    float dst[4][8];   // this chunk's state contribution: p = ty + 16r, n = tx + 16c
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) dst[r][c] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * T_;
      __syncthreads();  // ct, ss, gs, hs of the previous row tile are no longer read
      load_transposed(ct, cb, c0 + i0, min(T_, rows - i0), T_, brow, N);
      const float gv = block_scan(tid < T_ ? da[i0 + tid] : 0.f, wsum);
      if (tid < T_) gs[tid] = gv;
      if (it > 0) {  // thread t sums da over the t rows before the row tile
        const float hv = block_scan(tid >= 1 && tid < i0 ? da[i0 - tid] : 0.f, wsum);
        if (tid < i0) hs[i0 - 1 - tid] = hv;
      }
      __syncthreads();

      // inter-chunk term: acc[i][p] = exp(cum_i) * sum_n C[i, n] state[p, n]
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = ct[n * LD + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = st[n * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < T_ ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }

      // intra-chunk term, over the column tiles at or before this row tile
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T_;
        const int jrows = min(T_, rows - j0);
        __syncthreads();  // bt, xs and ss of the previous column tile are no longer read
        load_transposed(bt, bb, c0 + j0, jrows, T_, brow, N);
        for (int e = tid; e < T_ * P; e += NT) {
          const int j = e / P, p = e % P;
          xs[j * LD + p] = j < jrows
              ? to_float(xb[(int64_t)(c0 + j0 + j) * xrow + p]) * dtb[(int64_t)(c0 + j0 + j) * H]
              : 0.f;
        }
        if (jt == it && tid < T_) {  // the diagonal tile's decays, down column j
          const int j = tid;
          float seg = 0.f;
          ss[j * LD + j] = 1.f;
          for (int i = j + 1; i < T_; ++i) {
            seg += da[i0 + i];
            ss[i * LD + j] = expf(seg);
          }
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float av[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = ct[n * LD + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bt[n * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(av[r], bv[c], sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx + 16 * c;
            // select, never multiply: exp overflows above the diagonal
            float w = 0.f;
            if (i < T_ && j < T_) {
              if (jt < it) w = sc[r][c] * expf(gs[i] + hs[j0 + j]);
              else if (i >= j) w = sc[r][c] * ss[i * LD + j];
            }
            ss[i * LD + j] = w;
          }
        }
        __syncthreads();

        for (int j = 0; j < T_; ++j) {
          float av[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = ss[(ty + 16 * r) * LD + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = xs[j * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }

        // the last row tile visits every column tile of the chunk once:
        // gather the state contribution there
        if (it == ntiles - 1) {
          for (int j = 0; j < T_; ++j) {
            const float w = wd[j0 + j];
            float xv[4], bv[8];
#pragma unroll
            for (int r = 0; r < 4; ++r) xv[r] = xs[j * LD + ty + 16 * r] * w;
#pragma unroll
            for (int c = 0; c < 8; ++c) bv[c] = bt[(tx + 16 * c) * LD + j];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c) dst[r][c] = fmaf(xv[r], bv[c], dst[r][c]);
          }
        }
      }

      const int irows = min(T_, rows - i0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= irows) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yb[(int64_t)(c0 + i0 + i) * xrow + p] = from_float<T>(acc[r][c]);
        }
      }
    }

    __syncthreads();  // every row tile has read the old state
    const float decay = expf(cl);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = tx + 16 * c;
        if (p < P && n < N) st[n * LD + p] = fmaf(st[n * LD + p], decay, dst[r][c]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += NT) sf[so + e] = st[(e % N) * LD + e / N];
}

bool supported(int P, int N, int chunk) {
  const bool p_ok = P == 16 || P == 32 || P == PMAX;
  const bool n_ok = N == 8 || N == 16 || N == 32 || N == 64 || N == NMAX;
  const bool c_ok = chunk == 16 || chunk == 32 || chunk == 64 || chunk == 128 || chunk == CMAX;
  return p_ok && n_ok && c_ok;
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a_neg, const void* bm,
                   const void* cm, const float* s0, void* y, float* sf, int B, int S, int H,
                   int G, int P, int N, int chunk, cudaStream_t stream) {
  const int bytes = SMEM_FLOATS * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(H, B);
  ssd_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), dt, a_neg, static_cast<const T*>(bm),
      static_cast<const T*>(cm), s0, static_cast<T*>(y), sf, S, H, G, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int repro_ssd_scan_smem_bytes() { return SMEM_FLOATS * (int)sizeof(float); }

// x, y: (B, S, H, P); dt: (B, S, H) f32; a_neg: (H,) f32; b_mat, c_mat:
// (B, S, G, N); init_state (or null), final_state: (B, H, P, N) f32; x, y,
// b_mat and c_mat f32 or (is_bf16) bf16; all contiguous, on the current
// device.  Returns the launch's cudaError_t.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a_neg,
                              const void* b_mat, const void* c_mat, const void* init_state,
                              void* y, void* final_state, int B, int S, int H, int G, int P,
                              int N, int chunk, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || !supported(P, N, chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(a_neg);
  const float* s0 = static_cast<const float*>(init_state);
  float* sf = static_cast<float*>(final_state);
  cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(x, d, a, b_mat, c_mat, s0, y, sf, B, S, H, G, P, N, chunk, st)
      : launch<float>(x, d, a, b_mat, c_mat, s0, y, sf, B, S, H, G, P, N, chunk, st);
  return (int)err;
}
