// The expert products of a mixture-of-experts layer at decode shapes, for
// Hopper (sm_90a): for each expert e that holds a row,
//
//   h[e] = act(x[e] W_gate[e]) * (x[e] W_in[e])   (or gelu_tanh(x[e] W_in[e]))
//   y[e] = h[e] W_out[e]
//
// and exact zeros in y[e] for an expert whose row count is 0.
//
// Replaces no TPU kernel: the reference's experts are XLA einsums over every
// expert (repro/models/moe.py::_expert_ffn), as the port's were batched
// products over every expert.  It was added because at decode an expert
// holds one to four rows and most experts none (jamba-2p.chat: about 9 of
// 16 at top-2 over 6 rows; Kimi's held 24: about 2 at 4 rows x 8 picks of
// 384), yet a product over all experts streams every expert's weights.
// Which experts hold a row is decided on the device, from the routing, with
// no read on the host, so that a captured decode step (a CUDA graph)
// follows each replay's routing.
//
// What bounds it on an H100: bytes.  R <= 16 rows take 2 R FLOPs per weight
// element, R FLOPs a byte, far below the card's ridge of about 295: the
// least time is the occupied experts' weights over 3.35 TB/s.  What the
// design does about it:
//
// * Two launches a call, one kernel each: the up product (W_in and W_gate
//   read in the same pass, the activation applied after the sums are
//   complete, h rounded to bf16 as the unfused products round it), then
//   the down product.  Each has a static grid of (column tiles of BN,
//   splits of the depth K), chosen from shapes alone by the wrapper, of
//   about one block an SM: one wave, every block resident at once.
// * A block reads the counts first and walks the experts that hold a row,
//   in index order, through its column tile and its split: no weight of
//   an expert without rows is loaded, and no block is launched for one
//   (an early-exiting block would still hold its shared memory while its
//   count arrives).  Every block does the same work, whatever the count.
//   The down product's first split writes the zeros of the experts
//   without rows.
// * The depth is split finely enough that the grid gives each SM a block
//   (TARGET_BLOCKS in the wrapper): Kimi's 7168 x 2048 up product has 16
//   column tiles and 8 splits of 896 rows.  Twice as many blocks (two an
//   SM, more splits) measured slower at both shapes.
// * Weights stream through a ring of BK-row stages in 16-byte cp.async
//   copies, neighbouring threads on neighbouring addresses, each row of a
//   tile 256 contiguous bytes; the R rows of x (zero-filled to 16) ride
//   in the same stage.  The ring streams on from one expert's tiles into
//   the next's.  Products on the tensor cores (mma.sync m16n8k16,
//   the rows padded to 16, x read by ldmatrix, the weights by
//   ldmatrix.trans), f32 accumulators, each warp 32 columns of the tile.
// * With one split a block applies the epilogue to its own sums.  With
//   several, each writes its f32 partial sums to a workspace; the last
//   block of an (expert, column tile) to arrive, found by one
//   acquire-release atomicAdd on an int32 arrival counter after a block
//   barrier (K2's scheme), whose result the block reads only at its next
//   expert, adds the partials in split order (so a result does not depend
//   on which block came last), eight splits' loads in flight at once,
//   applies the epilogue, writes bf16 and resets its counter to zero for
//   the next launch.
//
// bf16 only: f32 keeps the batched products.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;       // threads a block: four warps
constexpr int BN = 128;       // output columns a block
constexpr int WN = BN / 4;    // a warp's columns: WN / 8 tiles of 8
constexpr int BK = 64;        // depth rows a ring stage
constexpr int ROWS = 16;      // rows an expert at most: the product's M
constexpr int MAX_EXPERTS = 384;
constexpr int SPLITS_AT_ONCE = 8;   // splits whose partials a sum loads together
constexpr int LDW = BN + 8;   // a weight tile's shared row (elements): 272 B, so the
                              // 8 rows of an ldmatrix fall on 8 bank groups
constexpr int LDX = BK + 8;   // an x tile's shared row: 144 B, likewise

enum Mode { kDown = 0, kSwiGLU = 1, kGelu = 2 };

template <int MODE>
struct Cfg {
  static constexpr int MATS = MODE == kSwiGLU ? 2 : 1;   // weight matrices a stage
  static constexpr int STAGE = MATS * BK * LDW + ROWS * LDX;   // elements a stage
  // 2 x 37120 B with two matrices, 4 x 19712 B with one (the depth and
  // count measured fastest at Kimi's and jamba's decode shapes; a third
  // stage or block an SM bought nothing)
  static constexpr int STAGES = MATS == 2 ? 2 : 4;
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(bf16);
};

struct Args {
  const bf16* x;        // (E, R, K)
  const int* counts;    // (E,) rows an expert holds; only 0 or not matters
  const bf16* w0;       // (E, K, N): W_in, or W_out in the down product
  const bf16* w1;       // (E, K, N): W_gate (kSwiGLU only)
  bf16* out;            // (E, R, N)
  float* ws;            // (E, splits, MATS, R, N) f32 partials (splits > 1)
  int* counters;        // one an (expert, column tile), zero between launches
  int E, R, K, N, splits, kc;
};

// atomicAdd with release and acquire semantics at GPU scope: returns the
// count before this arrival.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Depth rows [k, k + BK) of the block's weight tiles and of x into one
// ring stage; rows at or past k1, columns past N and x's rows past R are
// zero-filled (the copy reads nothing for them).
template <int MODE>
__device__ __forceinline__ void load_stage(const Args& a, bf16* st, int e, int n0, int k,
                                           int k1) {
  constexpr int PPR = BN / 8;   // 16-byte pieces a weight row
  static_assert(BK * PPR % NT == 0 && ROWS * BK / 8 <= NT, "a stage's pieces per thread");
#pragma unroll
  for (int m = 0; m < Cfg<MODE>::MATS; ++m) {
    const bf16* w = (m == 0 ? a.w0 : a.w1) + (int64_t)e * a.K * a.N;
    bf16* sw = st + m * BK * LDW;
#pragma unroll
    for (int p = 0; p < BK * PPR / NT; ++p) {
      const int i = threadIdx.x + p * NT, r = i / PPR, c = (i % PPR) * 8;
      const bool in = k + r < k1 && n0 + c < a.N;
      repro::cp_async16(sw + r * LDW + c, in ? w + (int64_t)(k + r) * a.N + n0 + c : w, in);
    }
  }
  // x: at most one 16-byte piece a thread
  const bf16* x = a.x + (int64_t)e * a.R * a.K;
  bf16* sx = st + Cfg<MODE>::MATS * BK * LDW;
  const int r = threadIdx.x / (BK / 8), c = (threadIdx.x % (BK / 8)) * 8;
  if (r >= ROWS) return;
  const bool in = r < a.R && k + c < k1;
  repro::cp_async16(sx + r * LDX + c, in ? x + (int64_t)r * a.K + k + c : x, in);
}

// acc[m][j] += x (16 x BK) . W_m (BK x 8) for the warp's WN / 8 column tiles j.
template <int MATS>
__device__ __forceinline__ void compute_stage(const bf16* st, float (&acc)[MATS][WN / 8][4],
                                              int warp, int lane) {
  const bf16* sx = st + MATS * BK * LDW;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t af[4];
    repro::ldmatrix_x4(af, sx + ((lane % 8) + ((lane / 8) % 2) * 8) * LDX + kk * 16
                               + (lane / 16) * 8);
#pragma unroll
    for (int m = 0; m < MATS; ++m)
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        uint32_t b[4];
        repro::ldmatrix_x4_trans(b, st + m * BK * LDW
                                        + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDW
                                        + warp * WN + j * 16 + (lane / 16) * 8);
        repro::mma_bf16(acc[m][2 * j], af, b[0], b[1]);
        repro::mma_bf16(acc[m][2 * j + 1], af, b[2], b[3]);
      }
  }
}

// The element of h or y from its complete f32 sums, rounded as PyTorch
// rounds the unfused products: each product to bf16, SiLU (x / (1 + e^-x))
// or tanh-GELU in f32 on the rounded value, rounded again, then the product
// with the rounded W_in sum (rounded by the store).
template <int MODE>
__device__ __forceinline__ float finish(float in, float gate) {
  if (MODE == kSwiGLU) {
    const float u = repro::round_to<bf16>(in), g = repro::round_to<bf16>(gate);
    return repro::round_to<bf16>(g / (1.f + expf(-g))) * u;
  }
  if (MODE == kGelu) {
    const float u = repro::round_to<bf16>(in);
    constexpr float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
    return 0.5f * u * (1.f + tanhf(kBeta * (u + kKappa * u * u * u)));
  }
  return in;
}

// Columns col and col + 1 of output row `row` of expert e.
template <int MODE>
__device__ __forceinline__ void emit(const Args& a, int e, int row, int col, float in0,
                                     float in1, float gate0, float gate1) {
  *reinterpret_cast<__nv_bfloat162*>(a.out + ((int64_t)e * a.R + row) * a.N + col) =
      __floats2bfloat162_rn(finish<MODE>(in0, gate0), finish<MODE>(in1, gate1));
}

// The block's sums of one (expert, column tile): through the epilogue with
// one split; with several, stored as its f32 partial of the tile.
template <int MODE>
__device__ __forceinline__ void write_sums(const Args& a, int e, int n0,
                                           const float (&acc)[Cfg<MODE>::MATS][WN / 8][4],
                                           int warp, int lane) {
  constexpr int MATS = Cfg<MODE>::MATS;
  // fragment (g, 2t..2t+1) and (g + 8, 2t..2t+1) of each 8-column tile
  const int g = lane / 4, t = lane % 4;
  const int64_t plane = (int64_t)a.R * a.N;   // one matrix's partial of one split
  float* part = a.ws + ((int64_t)e * a.splits + blockIdx.y) * MATS * plane;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = n0 + warp * WN + j * 8 + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = g + 8 * hr;
      if (row >= a.R || col >= a.N) continue;
      if (a.splits == 1) {
        emit<MODE>(a, e, row, col, acc[0][j][2 * hr], acc[0][j][2 * hr + 1],
                   acc[MATS - 1][j][2 * hr], acc[MATS - 1][j][2 * hr + 1]);
        continue;
      }
#pragma unroll
      for (int m = 0; m < MATS; ++m)
        *reinterpret_cast<float2*>(part + m * plane + (int64_t)row * a.N + col) =
            make_float2(acc[m][j][2 * hr], acc[m][j][2 * hr + 1]);
    }
  }
}

// Count the block in for expert e's column tile: a barrier (ordering every
// thread's partial before the release), then one acquire-release atomicAdd
// by thread 0, whose result (the count before this arrival) the caller
// reads one expert later, so the block does not wait for its round trip.
__device__ __forceinline__ int count_in(const Args& a, int e) {
  __syncthreads();
  return threadIdx.x == 0 ? arrive(a.counters + (int64_t)e * gridDim.x + blockIdx.x) : 0;
}

// Where the block was the last to count in for expert e's column tile
// (thread 0's `old`), it resets the counter for the next launch, adds the
// splits' partials in split order, SPLITS_AT_ONCE of them loaded together,
// and writes the tile.  Thread 0's acquire orders the other blocks'
// partials before the loads, carried to the block by the barrier.  The
// first barrier keeps thread 0 from setting `last` while a warp may still
// read the flag of the block's previous call.
template <int MODE>
__device__ __forceinline__ void sum_if_last(const Args& a, int e, int n0, int old, int* last) {
  constexpr int MATS = Cfg<MODE>::MATS;
  __syncthreads();
  if (threadIdx.x == 0) {
    *last = old == a.splits - 1;
    if (*last) a.counters[(int64_t)e * gridDim.x + blockIdx.x] = 0;
  }
  __syncthreads();
  if (!*last) return;
  const int64_t plane = (int64_t)a.R * a.N;
  const float* base = a.ws + (int64_t)e * a.splits * MATS * plane;
  for (int i = threadIdx.x; i < a.R * (BN / 2); i += NT) {
    const int row = i / (BN / 2), col = n0 + (i % (BN / 2)) * 2;
    if (col >= a.N) continue;
    const float* p = base + (int64_t)row * a.N + col;
    float2 s[MATS];
#pragma unroll
    for (int m = 0; m < MATS; ++m) s[m] = make_float2(0.f, 0.f);
    for (int s0 = 0; s0 < a.splits; s0 += SPLITS_AT_ONCE) {
      float2 v[SPLITS_AT_ONCE][MATS];
#pragma unroll
      for (int q = 0; q < SPLITS_AT_ONCE; ++q)
#pragma unroll
        for (int m = 0; m < MATS; ++m)
          v[q][m] = s0 + q < a.splits
                        ? __ldcg(reinterpret_cast<const float2*>(
                              p + ((s0 + q) * MATS + m) * plane))
                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < SPLITS_AT_ONCE; ++q)
#pragma unroll
        for (int m = 0; m < MATS; ++m) {
          s[m].x += v[q][m].x;
          s[m].y += v[q][m].y;
        }
    }
    emit<MODE>(a, e, row, col, s[0].x, s[0].y, s[MATS - 1].x, s[MATS - 1].y);
  }
}

// Grid (column tiles, splits): each block walks one column tile and one
// split of the depth through every expert that holds a row, in index
// order, its ring streaming on from one expert's weights into the next;
// dynamic shared memory Cfg<MODE>::SMEM.
template <int MODE>
__global__ void __launch_bounds__(NT) moe_experts_kernel(const Args a) {
  using C = Cfg<MODE>;
  constexpr int MATS = C::MATS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int occ[MAX_EXPERTS];   // the experts that hold a row, in index order
  __shared__ int n_occ, last;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * a.kc, k1 = min(k0 + a.kc, a.K);
  const int nt = (k1 - k0 + BK - 1) / BK;   // depth tiles an expert
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the counts, read first: no weight is loaded for an expert without rows
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < a.E; base += 32) {
      const int e = base + lane;
      const bool busy = e < a.E && a.counts[e] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, busy);
      if (busy) occ[n + __popc(m & ((1u << lane) - 1u))] = e;
      n += __popc(m);
    }
    if (lane == 0) n_occ = n;
  }
  __syncthreads();

  // the ring: tile `it` of the block's n_occ * nt is depth tile it % nt of
  // expert occ[it / nt], in stage it % STAGES; one copy group is committed
  // a tile (an empty one past the last), so tile `it` has landed once at
  // most STAGES - 1 groups are in flight
  const int total = n_occ * nt;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
#pragma unroll
  for (int i = 0; i < C::STAGES; ++i) {
    if (i < total)
      load_stage<MODE>(a, ring + i * C::STAGE, occ[i / nt], n0, k0 + (i % nt) * BK, k1);
    repro::cp_async_commit();
  }
  if (MODE == kDown && blockIdx.y == 0) {   // the zeros of the experts without rows, once
    constexpr int PPR = BN / 8;
    for (int e = 0; e < a.E; ++e) {
      if (a.counts[e] != 0) continue;
      for (int i = threadIdx.x; i < a.R * PPR; i += NT) {
        const int row = i / PPR, col = n0 + (i % PPR) * 8;
        if (col < a.N)
          *reinterpret_cast<uint4*>(a.out + ((int64_t)e * a.R + row) * a.N + col) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  float acc[MATS][WN / 8][4] = {};
  int pending = -1, old = 0;   // the expert last counted in, and thread 0's count for it
  for (int it = 0; it < total; ++it) {
    repro::cp_async_wait<C::STAGES - 1>();
    __syncthreads();
    bf16* st = ring + (it % C::STAGES) * C::STAGE;
    compute_stage<MATS>(st, acc, warp, lane);
    __syncthreads();   // every warp is done with the stage
    const int next = it + C::STAGES;
    if (next < total) load_stage<MODE>(a, st, occ[next / nt], n0, k0 + (next % nt) * BK, k1);
    repro::cp_async_commit();
    if (it % nt != nt - 1) continue;
    // the expert's last depth tile: its sums are complete
    const int e = occ[it / nt];
    write_sums<MODE>(a, e, n0, acc, warp, lane);
#pragma unroll
    for (int m = 0; m < MATS; ++m)
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
    if (a.splits > 1) {
      const int arrived = count_in(a, e);
      if (pending >= 0) sum_if_last<MODE>(a, pending, n0, old, &last);
      pending = e;
      old = arrived;
    }
  }
  if (pending >= 0) sum_if_last<MODE>(a, pending, n0, old, &last);
  repro::cp_async_wait<0>();
}

using Kernel = void (*)(Args);

Kernel kernel_of(int mode) {
  switch (mode) {
    case kDown: return moe_experts_kernel<kDown>;
    case kSwiGLU: return moe_experts_kernel<kSwiGLU>;
    case kGelu: return moe_experts_kernel<kGelu>;
    default: return nullptr;
  }
}

int smem_of(int mode) {
  switch (mode) {
    case kDown: return Cfg<kDown>::SMEM;
    case kSwiGLU: return Cfg<kSwiGLU>::SMEM;
    case kGelu: return Cfg<kGelu>::SMEM;
    default: return 0;
  }
}

// Allow every kernel its dynamic shared memory, once.
cudaError_t configure_all() {
  for (int mode = 0; mode < 3; ++mode) {
    cudaError_t err = cudaFuncSetAttribute(kernel_of(mode),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_of(mode));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch(int mode, const Args& a, cudaStream_t stream) {
  Args args = a;
  void* params[] = {&args};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel_of(mode)),
                                     dim3((a.N + BN - 1) / BN, a.splits), dim3(NT), params,
                                     smem_of(mode), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A product's split of depth K into `splits` pieces of `kc` rows (a
// multiple of BK), none of them empty.
bool valid_split(int K, int splits, int kc) {
  return splits > 0 && kc > 0 && kc % BK == 0 && (int64_t)splits * kc >= K
         && (int64_t)(splits - 1) * kc < K;
}

}  // namespace

// Dynamic shared memory (bytes) of one block and resident blocks per SM of
// the kernel of `mode` (0 down, 1 SwiGLU up, 2 GELU up); a negative value
// is a cudaError_t.
extern "C" int repro_moe_experts_smem_bytes(int mode) { return smem_of(mode); }

extern "C" int repro_moe_experts_blocks_per_sm(int mode) {
  if (!kernel_of(mode)) return -(int)cudaErrorInvalidValue;
  static cudaError_t configured = configure_all();
  if (configured != cudaSuccess) return -(int)configured;
  int n = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_of(mode), NT, smem_of(mode));
  return err == cudaSuccess ? n : -(int)err;
}

// x: (E, R, D); counts: (E,) int32; w_in, w_gate: (E, D, F) (w_gate null
// for tanh-GELU experts); w_out: (E, F, D); h: (E, R, F) scratch; y: (E, R,
// D); all bf16 but counts, contiguous, on the current device, 16-byte
// aligned.  ws: f32 scratch of E * max(up_splits * (1 or 2) * R * F,
// down_splits * R * D) where either split is above 1; counters: int32,
// zero, at least E * ceil(max(F, D) / 128) of them.  1 <= E <= 384, 1 <= R
// <= 16; D and F multiples of 8.  Launches the up product, then the down product, on
// `stream`.  Returns the launches' cudaError_t.
extern "C" int repro_moe_experts(const void* x, const void* counts, const void* w_in,
                                 const void* w_gate, const void* w_out, void* h, void* y,
                                 void* ws, void* counters, int E, int R, int D, int F,
                                 int up_splits, int up_kc, int down_splits, int down_kc,
                                 void* stream) {
  if (E <= 0 || E > MAX_EXPERTS || R < 1 || R > ROWS || D <= 0 || F <= 0 || D % 8 != 0
      || F % 8 != 0 || !valid_split(D, up_splits, up_kc) || !valid_split(F, down_splits, down_kc)
      || ((up_splits > 1 || down_splits > 1) && !ws))
    return (int)cudaErrorInvalidValue;
  static cudaError_t configured = configure_all();
  if (configured != cudaSuccess) return (int)configured;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const int* c = static_cast<const int*>(counts);
  const Args up{static_cast<const bf16*>(x), c, static_cast<const bf16*>(w_in),
                static_cast<const bf16*>(w_gate), static_cast<bf16*>(h), wsf, cnt,
                E, R, D, F, up_splits, up_kc};
  cudaError_t err = launch(w_gate ? kSwiGLU : kGelu, up, s);
  if (err != cudaSuccess) return (int)err;
  const Args down{static_cast<const bf16*>(h), c, static_cast<const bf16*>(w_out), nullptr,
                  static_cast<bf16*>(y), wsf, cnt, E, R, F, D, down_splits, down_kc};
  return (int)launch(kDown, down, s);
}
