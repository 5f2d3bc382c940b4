// The Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan /
// _ssd_kernel), whose grid (B, H, chunks) walks the chunk axis in order and
// carries the (P, N) state in VMEM scratch between grid steps.  Per chunk of
// `chunk` rows, with da = dt * a and seg(j, i) = sum of da over (j, i]:
//
//   y[i]   = exp(seg(-1, i)) * C_i . state^T                        (inter-chunk)
//          + sum_{j <= i} (C_i . B_j) exp(seg(j, i)) dt_j x_j        (intra-chunk)
//   state <- state * exp(seg(-1, end)) + sum_j x_j (dt_j exp(seg(j, end)) B_j)^T
//
// y is written in x's type and the final state in f32.
//
// What bounds it on an H100: bytes.  At the full-width prefill (B 4,
// S 1024, 80 heads of P 64, one group of N 128, chunk 256, bf16) the scan
// must move about 98 MB (29 us at 3.35 TB/s); its least arithmetic is about
// 16 GFLOP (16 us on the bf16 tensor cores).  Two implementations, chosen by
// dtype:
//
// * bf16 (the serving path): four chunk-parallel passes, every product on
//   the tensor cores (mma.sync m16n8k16, bf16 -> f32; helpers in mma.cuh):
//   1. ssd_cb_kernel: C . B^T once per (batch, chunk, group), lower-triangle
//      64 x 64 tiles only, into an f32 scratch (B, chunks, G, chunk, chunk);
//      both operands are the bf16 inputs, so the products are exact.
//   2. ssd_state_kernel: each (batch, chunk, head)'s contribution to the
//      state, dS = sum_j x_j (x) (dt_j exp(seg(j, end)) B_j), a P x N tile,
//      into an f32 scratch (B, chunks, H, P, N); also the chunk's total
//      decay exponent.
//   3. ssd_pass_kernel: per (batch, head), in chunk order and in place,
//      S_in(c) = S_in(c-1) exp(seg over chunk c-1) + dS(c-1), starting from
//      init_state or 0; writes the f32 final state.
//   4. ssd_out_kernel: y per (batch, chunk, head), one 64-row tile after
//      another: the inter-chunk product with S_in(c), then the intra-chunk
//      product over the column tiles at or before the row tile, with the
//      weights W = CB * exp(seg(j, i)) * dt_j built in registers from the
//      pass-1 tile.
//   x, B and C enter the products as they are.  Every f32 operand (W, the
//   scaled B of pass 2, the state of pass 4) enters as three bf16 terms,
//   hi + mid + lo: three products into a zeroed fragment, added to the f32
//   accumulator, so y rounds to bf16 almost as it would from f32 operands.
//   Rounding any of them to bf16 once misses the f32 state tolerance and
//   the bf16 y tolerance; two terms (hi + lo) hold both tolerances but
//   round about ten times as many outputs to another bf16 value than the
//   f32 plain version does (6e-4 of them against 5e-5 to 8e-5 on an H100),
//   which moves the greedy tokens of the 64-layer bf16 mamba2 model farther
//   from an exact evaluation than the plain version's; chip_smoke.py
//   refuses both.  Blocks are four warps (eight in pass 2)
//   and at most about 102 KB of shared memory, so two or more share an SM;
//   loads from device memory go out in batches (cp.async, or vector loads
//   into registers, in pass 4 while the previous column tile's products
//   run), and the per-row and per-column decay factors are computed once a
//   block, outside the product loops.
// * f32 (the reduced families the profiler measures, and the f32 parity
//   checks): ssd_kernel, one block a (batch, head) walking the chunks in
//   order with the f32 state in shared memory and every product on the f32
//   CUDA cores, as the TPU kernel computes it.
//
// Every decay exponent is summed directly over its own segment, never taken
// as a difference of two prefix sums: over a 256-row chunk the prefix sums
// reach thousands, and a difference of two of them keeps only a few 1e-4 of
// absolute precision.  Each partial sum adds terms of one sign (da <= 0),
// and exp(seg(j, i)) may be split into a factor per row times a factor per
// column (exp(G_i) exp(H_j), G and H summed over the two parts of the
// segment).  The plain version sums the same segments (segsum in
// ssd_scan.py).
//
// The upper triangle (i < j) would overflow exp, so it is never computed: a
// weight there is set to 0, not multiplied by a 0/1 mask.  Rows past S (the
// ragged last chunk) load as x = 0, dt = 0, B = C = 0: decay 1 and no
// contribution, as the zero padding of the reference gives; nothing is
// written past S.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: one block a (batch, head), the chunks in order, CUDA-core products.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: four tensor-core passes.  Blocks are four warps (eight in pass 2);
// warp w owns the 16-row slice 16w .. 16w+15 of its 64-row tile (fewer
// warps work when the chunk is shorter than 64).
// ---------------------------------------------------------------------------
constexpr int TC_NT = 128;
constexpr int STATE_NT = 256;   // pass 2: eight warps, 16 rows of P by half of N each
constexpr int LDN = NMAX + 8;   // bf16 row of N values, padded by 16 bytes
constexpr int LDP = PMAX + 8;   // bf16 row of P values, padded by 16 bytes
constexpr int LDC = TM + 8;     // f32 row of a C.B^T tile
using bf16 = __nv_bfloat16;

constexpr int CB_SMEM = 2 * TM * LDN * (int)sizeof(bf16);
constexpr int STATE_SMEM = TM * LDP * (int)sizeof(bf16) + 3 * TM * LDN * (int)sizeof(bf16)
                           + 3 * CMAX * (int)sizeof(float);
constexpr int OUT_SMEM = TM * LDN * (int)sizeof(bf16) + 3 * PMAX * LDN * (int)sizeof(bf16)
                         + TM * LDP * (int)sizeof(bf16) + TM * LDC * (int)sizeof(float)
                         + (2 * CMAX + 4 * CMAX + 2 * TM) * (int)sizeof(float);

// Copy rows [row0, row0 + 64) of a bf16 matrix with `width` columns (a
// multiple of 8; row r at src + r * stride) into shared rows of `ld`,
// `wpad` columns wide: rows at or past `rows` and columns past `width` are
// zero.
__device__ __forceinline__ void load_bf16_rows(bf16* dst, int ld, const bf16* src,
                                               int64_t stride, int row0, int rows, int width,
                                               int wpad) {
  const int cpr = wpad / 8;
  for (int e = threadIdx.x; e < TM * cpr; e += blockDim.x) {
    const int r = e / cpr, c = e % cpr;
    const bool in = row0 + r < rows && c * 8 < width;
    repro::cp_async16(dst + r * ld + c * 8, in ? src + (row0 + r) * stride + c * 8 : src, in);
  }
}

// For j < n: out[j] = scale[j] * exp(sum_{k in (j, n)} v[k]); returns the
// sum of v[0 .. n) to every lane.  One warp, n <= 256.  Lane L sums a run
// of consecutive terms, and the runs after it come from a suffix scan over
// the lanes: every exponent is a sum of the terms of its own segment.
__device__ __forceinline__ float warp_suffix_exp(const float* v, const float* scale, int n,
                                                 float* out) {
  const int lane = threadIdx.x % 32;
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per), hi = min(n, lo + per);
  float run = 0.f;
  for (int k = lo; k < hi; ++k) run += v[k];
  float after = __shfl_down_sync(0xffffffffu, run, 1);   // runs of the lanes after this one
  if (lane == 31) after = 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, after, o);
    if (lane + o < 32) after += u;
  }
  const float total = __shfl_sync(0xffffffffu, after + run, 0);
  for (int k = hi - 1; k >= lo; --k) {
    out[k] = scale[k] * expf(after);
    after += v[k];
  }
  return total;
}

// Load dt and dt * a for the chunk's rows [0, n) (0 past the sequence).
__device__ __forceinline__ void load_decays(float* sdt, float* sda, const float* dtb, int64_t H,
                                            float a, int rows, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = i < rows ? dtb[i * H] : 0.f;
    sdt[i] = d;
    sda[i] = d * a;
  }
}

// Pass 1.  Grid (row/column tile pairs J <= I, chunks * G, B).
__global__ void __launch_bounds__(TC_NT)
ssd_cb_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm, float* __restrict__ cb,
              int S, int G, int N, int chunk) {
  using namespace repro;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sc = reinterpret_cast<bf16*>(smem_raw);   // C rows of the row tile
  bf16* sb = sc + TM * LDN;                       // B rows of the column tile
  const int T = min(chunk, TM), NP = max(N, 16);
  int I = 0, J = blockIdx.x;
  while (J > I) J -= ++I;
  const int c = blockIdx.y / G, g = blockIdx.y % G, b = blockIdx.z;
  const int nc = gridDim.y / G;
  const int c0 = c * chunk, rows = min(chunk, S - c0);
  const int i0 = I * T, j0 = J * T;
  if (i0 >= rows) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;

  const int64_t brow = (int64_t)G * N;
  const int64_t base = ((int64_t)b * S + c0) * brow + (int64_t)g * N;
  load_bf16_rows(sc, LDN, cm + base, brow, i0, rows, N, NP);
  load_bf16_rows(sb, LDN, bm + base, brow, j0, rows, N, NP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (16 * warp >= T) return;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int ks = 0; ks < NP / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, sc + (16 * warp + (lane % 8) + ((lane / 8) % 2) * 8) * LDN + ks * 16
                       + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np * 16 >= T) break;
      uint32_t r[4];
      ldmatrix_x4(r, sb + (np * 16 + (lane % 8) + (lane / 16) * 8) * LDN + ks * 16
                         + ((lane / 8) % 2) * 8);
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(t0, a, r[0], r[1]);
      mma_bf16(t1, a, r[2], r[3]);
      add_frag(acc[2 * np], t0);
      add_frag(acc[2 * np + 1], t1);
    }
  }
  float* out = cb + (((int64_t)b * nc + c) * G + g) * chunk * chunk;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j * 8 >= T) break;
    const int col = j0 + 8 * j + 2 * t;
    const int row = i0 + 16 * warp + gq;
    *reinterpret_cast<float2*>(out + (int64_t)row * chunk + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (int64_t)(row + 8) * chunk + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// Pass 2.  Grid (H, chunks, B); eight warps, warp w owning rows
// 16 (w % 4) .. +15 of the P x N tile and half of its columns.
__global__ void __launch_bounds__(STATE_NT)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_neg, const bf16* __restrict__ bm,
                 float* __restrict__ states, float* __restrict__ csum, int S, int H, int G, int P,
                 int N, int chunk) {
  using namespace repro;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);   // x rows of the column tile: [j][p]
  bf16* sbs = sx + TM * LDP;   // the scaled B rows as hi, mid, lo: 3 x [j][n]
  float* sdt = reinterpret_cast<float*>(sbs + 3 * TM * LDN);
  float* sda = sdt + CMAX;
  float* sw = sda + CMAX;      // dt_j exp(seg(j, end))
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int g = h / (H / G);
  const int T = min(chunk, TM), NP = max(N, 16);
  const int c0 = c * chunk, rows = min(chunk, S - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int halves = NP >= 32 ? 2 : 1;       // column halves the warps split
  const int nps = NP / 16 / halves;          // 16-wide column pairs a warp
  const int pw = 16 * (warp % 4), np0 = (warp / 4) * nps;
  const bool active = pw < P && warp / 4 < halves;

  load_decays(sdt, sda, dt + ((int64_t)b * S + c0) * H + h, H, a_neg[h], rows, chunk);
  __syncthreads();
  if (warp == 0) {
    const float total = warp_suffix_exp(sda, sdt, chunk, sw);
    if (lane == 0) csum[((int64_t)b * nc + c) * H + h] = total;
  }
  __syncthreads();

  const int64_t xrow = (int64_t)H * P, brow = (int64_t)G * N;
  const bf16* xb = x + ((int64_t)b * S + c0) * xrow + (int64_t)h * P;
  const bf16* bb = bm + ((int64_t)b * S + c0) * brow + (int64_t)g * N;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int j0 = 0; j0 < rows; j0 += T) {
    load_bf16_rows(sx, LDP, xb, xrow, j0, rows, P, P);
    cp_async_commit();
    // B rows scaled by dt_j exp(seg(j, end)), split in three: eight values
    // a thread and load, every load in flight at once (T * N / 8 <= 4 * 256)
    const int per_row = N / 8, pieces = T * per_row;
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = u * STATE_NT + threadIdx.x, r = e / per_row;
      raw[u] = e < pieces && j0 + r < rows
          ? *reinterpret_cast<const uint4*>(bb + (j0 + r) * brow + (e % per_row) * 8)
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = u * STATE_NT + threadIdx.x;
      if (e >= pieces) break;
      const int r = e / per_row, n = (e % per_row) * 8;
      const float sc = j0 + r < rows ? sw[j0 + r] : 0.f;
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      uint4 part[3];
      uint32_t* hi = &part[0].x;
      uint32_t* mid = &part[1].x;
      uint32_t* lo = &part[2].x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(v[k]);
        split3_bf16(f.x * sc, f.y * sc, hi[k], mid[k], lo[k]);
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint4*>(sbs + q * TM * LDN + r * LDN + n) = part[q];
    }
    if (N < NP)   // d_state 8: zero the padding to the k-step of 16
      for (int e = threadIdx.x; e < 3 * T; e += STATE_NT)
        *reinterpret_cast<uint4*>(sbs + (e / T) * TM * LDN + (e % T) * LDN + N) =
            make_uint4(0, 0, 0, 0);
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      for (int ks = 0; ks < T / 16; ++ks) {
        uint32_t a[4];   // x^T: rows p, depth j
        ldmatrix_x4_trans(a, sx + (ks * 16 + (lane % 8) + (lane / 16) * 8) * LDP + pw
                                 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= nps) break;
          const int off = (ks * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDN
                          + (np0 + np) * 16 + (lane / 16) * 8;
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 3; ++q) {   // hi, mid, lo
            uint32_t r[4];
            ldmatrix_x4_trans(r, sbs + q * TM * LDN + off);
            mma_bf16(t0, a, r[0], r[1]);
            mma_bf16(t1, a, r[2], r[3]);
          }
          add_frag(acc[2 * np], t0);
          add_frag(acc[2 * np + 1], t1);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* out = states + (((int64_t)b * nc + c) * H + h) * P * N;
  const int p = pw + gq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = np0 * 16 + 8 * j + 2 * t;
    if (j >= 2 * nps || n >= N) break;
    *reinterpret_cast<float2*>(out + p * N + n) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (p + 8) * N + n) = make_float2(acc[j][2], acc[j][3]);
  }
}

// Pass 3.  Grid (P * N / 512, H, B): four state elements a thread, over
// the chunks in order, four chunks' loads in flight at once; states[c]
// becomes the state entering chunk c.
__global__ void __launch_bounds__(TC_NT)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ csum,
                const float* __restrict__ s0, float* __restrict__ sf, int H, int PN, int nc) {
  const int e = 4 * (blockIdx.x * TC_NT + threadIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const int64_t so = ((int64_t)b * H + h) * PN + e;
  float4 s = s0 ? *reinterpret_cast<const float4*>(s0 + so) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 d[4];
    float decay[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      const int64_t bc = (int64_t)b * nc + c0 + u;
      d[u] = *reinterpret_cast<const float4*>(states + (bc * H + h) * PN + e);
      decay[u] = expf(csum[bc * H + h]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      const int64_t bc = (int64_t)b * nc + c0 + u;
      *reinterpret_cast<float4*>(states + (bc * H + h) * PN + e) = s;
      s = make_float4(fmaf(s.x, decay[u], d[u].x), fmaf(s.y, decay[u], d[u].y),
                      fmaf(s.z, decay[u], d[u].z), fmaf(s.w, decay[u], d[u].w));
    }
  }
  *reinterpret_cast<float4*>(sf + so) = s;
}

// Pass 4.  Grid (H, B * chunks): a block walks the row tiles of its chunk,
// so the state is loaded and split, and the decays read, once a chunk.
// FULL: 64-row tiles, P 64 and N 128 (mamba2-2.7b) as compile-time widths,
// so that the loops over them unroll.
template <bool FULL>
__global__ void __launch_bounds__(TC_NT)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_neg, const bf16* __restrict__ cm,
               const float* __restrict__ cb, const float* __restrict__ states,
               bf16* __restrict__ y, int S, int H, int G, int P, int N, int chunk, int nc) {
  using namespace repro;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sc = reinterpret_cast<bf16*>(smem_raw);   // C rows of the row tile: [i][n]
  bf16* sss = sc + TM * LDN;                      // S_in as hi, mid, lo: 3 x [p][n]
  bf16* sx = sss + 3 * PMAX * LDN;                // x rows of the column tile: [j][p]
  float* scb = reinterpret_cast<float*>(sx + TM * LDP);   // C.B^T tile: [i][j]
  float* sdt = scb + TM * LDC;
  float* sda = sdt + CMAX;
  float* scol = sda + CMAX;       // per warp: dt_j exp(sum of da over (j, warp's first row))
  float* srow = scol + 4 * CMAX;  // exp(sum of da over [warp's first row, i])
  float* sin_ = srow + TM;        // exp(sum of da over [0, i]): the inter-chunk decay

  const int h = blockIdx.x, b = blockIdx.y / nc, c = blockIdx.y % nc;
  if (FULL) P = PMAX, N = NMAX;   // compile-time widths
  const int T = FULL ? TM : min(chunk, TM), NP = max(N, 16);
  const int c0 = c * chunk, rows = min(chunk, S - c0);
  const int g = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;

  const int64_t xrow = (int64_t)H * P, brow = (int64_t)G * N;
  const bf16* xb = x + ((int64_t)b * S + c0) * xrow + (int64_t)h * P;
  const bf16* cc = cm + ((int64_t)b * S + c0) * brow + (int64_t)g * N;
  bf16* yb = y + ((int64_t)b * S + c0) * xrow + (int64_t)h * P;
  load_decays(sdt, sda, dt + ((int64_t)b * S + c0) * H + h, H, a_neg[h], rows, chunk);
  const float* st = states + (((int64_t)b * nc + c) * H + h) * P * N;
  // S_in split in three: four values a thread and load, sixteen loads of a
  // batch in flight at once
  const int per_row = N / 4, pieces = P * per_row;
  for (int base = 0; base < pieces; base += 16 * TC_NT) {
    float4 v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = base + u * TC_NT + threadIdx.x;
      v[u] = e < pieces ? *reinterpret_cast<const float4*>(st + 4 * e)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = base + u * TC_NT + threadIdx.x;
      if (e >= pieces) break;
      const int off = (e / per_row) * LDN + (e % per_row) * 4;
      uint2 part[3];
      split3_bf16(v[u].x, v[u].y, part[0].x, part[1].x, part[2].x);
      split3_bf16(v[u].z, v[u].w, part[0].y, part[1].y, part[2].y);
#pragma unroll
      for (int q = 0; q < 3; ++q) *reinterpret_cast<uint2*>(sss + q * PMAX * LDN + off) = part[q];
    }
  }
  if (N < NP)   // d_state 8: zero the padding to the k-step of 16
    for (int e = threadIdx.x; e < 3 * P; e += TC_NT)
      *reinterpret_cast<uint4*>(sss + (e / P) * PMAX * LDN + (e % P) * LDN + N) =
          make_uint4(0, 0, 0, 0);

  for (int I = 0; I * T < rows; ++I) {
    const int i0 = I * T;
    const int r0 = i0 + 16 * warp;   // the warp's first row in the chunk
    const bool active = 16 * warp < T && r0 < rows;
    __syncthreads();   // the last row tile no longer reads sc, srow, sin_, scol
    load_bf16_rows(sc, LDN, cc, brow, i0, rows, N, NP);
    cp_async_commit();
    if (active) {
      const float before = warp_suffix_exp(sda, sdt, r0, scol + warp * CMAX);
      if (lane < 16) {
        float gs = 0.f;
        for (int k = r0; k <= r0 + lane; ++k) gs += sda[k];
        srow[16 * warp + lane] = expf(gs);
        sin_[16 * warp + lane] = expf(before + gs);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int rl0 = 16 * warp + gq, rl1 = rl0 + 8;   // this thread's rows in the tile
    if (active) {   // inter-chunk: exp(seg(-1, i)) C_i . S_in^T
#pragma unroll
      for (int ks = 0; ks < NP / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, sc + (16 * warp + (lane % 8) + ((lane / 8) % 2) * 8) * LDN + ks * 16
                           + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np * 16 >= P) break;
          const int off = (np * 16 + (lane % 8) + (lane / 16) * 8) * LDN + ks * 16
                          + ((lane / 8) % 2) * 8;
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 3; ++q) {   // hi, mid, lo
            uint32_t r[4];
            ldmatrix_x4(r, sss + q * PMAX * LDN + off);
            mma_bf16(t0, a, r[0], r[1]);
            mma_bf16(t1, a, r[2], r[3]);
          }
          add_frag(acc[2 * np], t0);
          add_frag(acc[2 * np + 1], t1);
        }
      }
      const float e0 = sin_[rl0], e1 = sin_[rl1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }

    const float* cbt = cb + (((int64_t)b * nc + c) * G + g) * chunk * chunk;
    const float* colf = scol + warp * CMAX;
    // column tile J (its C.B^T tile and x rows) is fetched into registers
    // while tile J - 1's products run, then stored to shared memory
    float4 pcb[8];   // T x T f32: T * T / 4 <= 8 * 128 pieces
    uint4 px[4];     // T x P bf16: T * P / 8 <= 4 * 128 pieces
    auto fetch = [&](int J) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = u * TC_NT + threadIdx.x, r = e / (T / 4), q = e % (T / 4);
        pcb[u] = e < T * (T / 4)
            ? *reinterpret_cast<const float4*>(cbt + (int64_t)(i0 + r) * chunk + J * T + 4 * q)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = u * TC_NT + threadIdx.x, r = e / (P / 8), q = e % (P / 8);
        px[u] = e < T * (P / 8) && J * T + r < rows
            ? *reinterpret_cast<const uint4*>(xb + (J * T + r) * xrow + 8 * q)
            : make_uint4(0, 0, 0, 0);
      }
    };
    auto put = [&]() {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = u * TC_NT + threadIdx.x;
        if (e < T * (T / 4))
          *reinterpret_cast<float4*>(scb + (e / (T / 4)) * LDC + 4 * (e % (T / 4))) = pcb[u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = u * TC_NT + threadIdx.x;
        if (e < T * (P / 8))
          *reinterpret_cast<uint4*>(sx + (e / (P / 8)) * LDP + 8 * (e % (P / 8))) = px[u];
      }
    };
    fetch(0);
    for (int J = 0; J <= I; ++J) {
      const int j0 = J * T;
      __syncthreads();   // the previous column tile is no longer read
      put();
      __syncthreads();
      if (J < I) fetch(J + 1);
      if (!active) continue;
#pragma unroll
      for (int v = 0; v < T / 16; ++v) {
        if (J == I && v > warp) break;   // wholly above the diagonal
        const bool diag = J == I && v == warp;
        // the warp's own 16 x 16 diagonal block: seg(j, i) summed here, walking
        // down from row i; seg[r][q] for row g + 8r, column 2t + (q & 1) + 8 (q >> 1)
        float seg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (diag) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int il = gq + 8 * r;
            float run = 0.f;
#pragma unroll
            for (int k = 15; k >= 1; --k) {
              if (k <= il) run += sda[r0 + k];
              const int j = k - 1;   // run is now the sum over (j, i]
              if (j == 2 * t) seg[r][0] = run;
              if (j == 2 * t + 1) seg[r][1] = run;
              if (j == 2 * t + 8) seg[r][2] = run;
              if (j == 2 * t + 9) seg[r][3] = run;
            }
          }
        }
        // W = CB * exp(seg(j, i)) * dt_j as hi, mid, lo A fragments
        uint32_t aw[3][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rl = q & 1 ? rl1 : rl0;
          const int cl = 16 * v + 2 * t + (q >> 1) * 8;
          const float2 cbv = *reinterpret_cast<const float2*>(scb + rl * LDC + cl);
          float w0, w1;
          if (!diag) {
            const float f = srow[rl];
            w0 = cbv.x * f * colf[j0 + cl];
            w1 = cbv.y * f * colf[j0 + cl + 1];
          } else {   // select, never multiply: exp overflows above the diagonal
            const int il = gq + 8 * (q & 1), jl = 2 * t + (q >> 1) * 8;
            const float* sg = seg[q & 1] + 2 * (q >> 1);
            w0 = jl <= il ? cbv.x * sdt[r0 + jl] * expf(sg[0]) : 0.f;
            w1 = jl + 1 <= il ? cbv.y * sdt[r0 + jl + 1] * expf(sg[1]) : 0.f;
          }
          split3_bf16(w0, w1, aw[0][q], aw[1][q], aw[2][q]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np * 16 >= P) break;
          uint32_t r[4];
          ldmatrix_x4_trans(r, sx + (16 * v + (lane % 8) + ((lane / 8) % 2) * 8) * LDP + np * 16
                                   + (lane / 16) * 8);
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 3; ++q) {   // hi, mid, lo
            mma_bf16(t0, aw[q], r[0], r[1]);
            mma_bf16(t1, aw[q], r[2], r[3]);
          }
          add_frag(acc[2 * np], t0);
          add_frag(acc[2 * np + 1], t1);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j * 8 >= P) break;
        const int p = 8 * j + 2 * t;
        if (i0 + rl0 < rows)
          *reinterpret_cast<uint32_t*>(yb + (i0 + rl0) * xrow + p) =
              pack_bf16(acc[j][0], acc[j][1]);
        if (i0 + rl1 < rows)
          *reinterpret_cast<uint32_t*>(yb + (i0 + rl1) * xrow + p) =
              pack_bf16(acc[j][2], acc[j][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
bool supported(int P, int N, int chunk) {
  const bool p_ok = P == 16 || P == 32 || P == PMAX;
  const bool n_ok = N == 8 || N == 16 || N == 32 || N == 64 || N == NMAX;
  const bool c_ok = chunk == 16 || chunk == 32 || chunk == 64 || chunk == 128 || chunk == CMAX;
  return p_ok && n_ok && c_ok;
}

// The kernels, their block sizes and their dynamic shared memory, in the
// order of repro_ssd_scan_kernel_name: 0 the f32 kernel, 1-4 the bf16 passes.
constexpr int N_KERNELS = 6;
const void* const kKernels[N_KERNELS] = {
    reinterpret_cast<const void*>(ssd_kernel<float>), reinterpret_cast<const void*>(ssd_cb_kernel),
    reinterpret_cast<const void*>(ssd_state_kernel),
    reinterpret_cast<const void*>(ssd_pass_kernel),
    reinterpret_cast<const void*>(ssd_out_kernel<true>),
    reinterpret_cast<const void*>(ssd_out_kernel<false>)};
const char* const kNames[N_KERNELS] = {"ssd_kernel<f32>",      "ssd_cb_kernel",
                                       "ssd_state_kernel",     "ssd_pass_kernel",
                                       "ssd_out_kernel<full>", "ssd_out_kernel<any>"};
constexpr int kThreads[N_KERNELS] = {NT, TC_NT, STATE_NT, TC_NT, TC_NT, TC_NT};
constexpr int kSmem[N_KERNELS] = {SMEM_FLOATS * (int)sizeof(float), CB_SMEM, STATE_SMEM, 0,
                                  OUT_SMEM, OUT_SMEM};

cudaError_t configure() {
  static const cudaError_t err = [] {
    for (int i = 0; i < N_KERNELS; ++i) {
      const cudaError_t e = cudaFuncSetAttribute(
          kKernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem[i]);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return err;
}

cudaError_t launch_f32(const void* x, const float* dt, const float* a_neg, const void* bm,
                       const void* cm, const float* s0, void* y, float* sf, int B, int S, int H,
                       int G, int P, int N, int chunk, cudaStream_t stream) {
  dim3 grid(H, B);
  ssd_kernel<float><<<grid, NT, kSmem[0], stream>>>(
      static_cast<const float*>(x), dt, a_neg, static_cast<const float*>(bm),
      static_cast<const float*>(cm), s0, static_cast<float*>(y), sf, S, H, G, P, N, chunk);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const float* dt, const float* a_neg, const void* bm,
                        const void* cm, const float* s0, void* y, float* sf, float* cb,
                        float* states, float* csum, int B, int S, int H, int G, int P, int N,
                        int chunk, cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cc = static_cast<const bf16*>(cm);
  const int nc = (S + chunk - 1) / chunk;
  const int nt = chunk / min(chunk, TM);
  ssd_cb_kernel<<<dim3(nt * (nt + 1) / 2, nc * G, B), TC_NT, CB_SMEM, stream>>>(bb, cc, cb, S, G,
                                                                                N, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_kernel<<<dim3(H, nc, B), STATE_NT, STATE_SMEM, stream>>>(xb, dt, a_neg, bb, states,
                                                                  csum, S, H, G, P, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_pass_kernel<<<dim3((P * N / 4 + TC_NT - 1) / TC_NT, H, B), TC_NT, 0, stream>>>(
      states, csum, s0, sf, H, P * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 64-row tiles and the widest state (mamba2-2.7b's) take an output pass
  // whose loops the compiler unrolls in full
  const dim3 out_grid(H, B * nc);
  if (chunk >= TM && P == PMAX && N == NMAX)
    ssd_out_kernel<true><<<out_grid, TC_NT, OUT_SMEM, stream>>>(
        xb, dt, a_neg, cc, cb, states, static_cast<bf16*>(y), S, H, G, P, N, chunk, nc);
  else
    ssd_out_kernel<false><<<out_grid, TC_NT, OUT_SMEM, stream>>>(
        xb, dt, a_neg, cc, cb, states, static_cast<bf16*>(y), S, H, G, P, N, chunk, nc);
  return cudaGetLastError();
}

}  // namespace

// Number of device kernels in the library, and each one's name, dynamic
// shared memory (bytes) and resident blocks per SM (from the occupancy
// calculator; a negative value is a cudaError_t).  0 is the f32 kernel,
// 1-4 the bf16 passes in launch order.
extern "C" int repro_ssd_scan_kernel_count() { return N_KERNELS; }
extern "C" const char* repro_ssd_scan_kernel_name(int i) {
  return i >= 0 && i < N_KERNELS ? kNames[i] : "";
}
extern "C" int repro_ssd_scan_smem_bytes(int i) { return i >= 0 && i < N_KERNELS ? kSmem[i] : 0; }
extern "C" int repro_ssd_scan_blocks_per_sm(int i) {
  if (i < 0 || i >= N_KERNELS) return 0;
  cudaError_t err = configure();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kKernels[i], kThreads[i], kSmem[i]);
  return err == cudaSuccess ? n : -(int)err;
}

// x, y: (B, S, H, P); dt: (B, S, H) f32; a_neg: (H,) f32; b_mat, c_mat:
// (B, S, G, N); init_state (or null), final_state: (B, H, P, N) f32; x, y,
// b_mat and c_mat f32 or (is_bf16) bf16, 16-byte aligned; all contiguous,
// on the current device.  The bf16 passes take three f32 scratch buffers:
// cb (B, chunks, G, chunk, chunk), states (B, chunks, H, P, N) and csum
// (B, chunks, H); the f32 kernel ignores them.  Returns the first launch's
// cudaError_t that is not cudaSuccess.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a_neg,
                              const void* b_mat, const void* c_mat, const void* init_state,
                              void* y, void* final_state, void* cb, void* states, void* csum,
                              int B, int S, int H, int G, int P, int N, int chunk, int is_bf16,
                              void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || !supported(P, N, chunk))
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && (!cb || !states || !csum)) return (int)cudaErrorInvalidValue;
  const cudaError_t conf = configure();
  if (conf != cudaSuccess) return (int)conf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(a_neg);
  const float* s0 = static_cast<const float*>(init_state);
  float* sf = static_cast<float*>(final_state);
  cudaError_t err = is_bf16
      ? launch_bf16(x, d, a, b_mat, c_mat, s0, y, sf, static_cast<float*>(cb),
                    static_cast<float*>(states), static_cast<float*>(csum), B, S, H, G, P, N,
                    chunk, st)
      : launch_f32(x, d, a, b_mat, c_mat, s0, y, sf, B, S, H, G, P, N, chunk, st);
  return (int)err;
}
