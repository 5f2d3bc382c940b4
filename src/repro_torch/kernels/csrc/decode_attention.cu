// One-token decode attention over a KV cache for Hopper (sm_90a), with the
// cache axis split across blocks ("flash-decoding").
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel), which walks the cache blocks of one
// (batch, KV head) in order on one core with the GQA group's softmax state
// in VMEM.
//
// What bounds it on an H100: bytes.  A step reads the valid slots of K and
// V once, 2 * n * KV * hd elements, for 4 * H * n * hd FLOPs: G / itemsize
// FLOPs a byte for a GQA group of G heads, far below the card's ridge of
// about 295.  At the serving shapes the cache is small (12.6 MB at phi-3's
// first decode step), so the time is the latency of device memory unless
// every SM keeps enough bytes in flight.  What the design does about it:
//
// * Grid (splits, KV * row chunks, B).  Each block takes a contiguous range
//   of `chunk` slots (a multiple of 64).  The wrapper's split_plan picks
//   splits from B, KV and L so that about one block stands on each of the
//   132 SMs: a split costs a combine at the end (a few round trips to L2),
//   and more, shallower blocks measured slower than fewer, deeper ones.
// * K and V tiles of 64 slots stay in their own dtype in shared memory and
//   arrive as 16-byte cp.async copies, neighbouring threads on neighbouring
//   addresses, into a ring of up to four stages.  The first stages are
//   issued before lengths[b] has arrived (the slots lie inside the cache
//   whatever it says), so a block pays the latency of device memory about
//   once; later stages stream in while earlier ones are computed.  The
//   block computes only the slots below n = min(lengths[b], L).
// * Inside a block, every warp works on its own slots with its own online
//   softmax (row max, row sum, accumulator in registers), so a tile needs
//   no block-wide reduction; the block merges its sub-states once, through
//   shared memory, at the end.
// * Each split writes f32 partials (m, l, acc) to a workspace.  The last
//   block of a (batch, KV head, row chunk) to finish, found by one
//   acquire-release atomicAdd on an int32 arrival counter after a block
//   barrier (a __threadfence() in every thread cost more than the read of
//   the cache), combines them in registers, one round of loads for up to
//   eight splits, writes the output and resets its counter to zero.  With
//   one split the block writes the output itself.  One launch per call.
//
// Two kernels, chosen by dtype:
//
// * decode_split_tc_kernel<HD> (bf16 at every G: the serving path, phi-3 at
//   G = 1 and yi-34b at G = 7): tensor cores, mma.sync m16n8k16 with the
//   group padded to 16 rows (chunks of 16 along y past that).  Each warp
//   takes 16 slots of a 64-slot tile: S = Q K^T from Q fragments held in
//   registers and K read by ldmatrix, the f32 score fragment exponentiated
//   in registers and fed back as the A operand of O += P V with V read by
//   ldmatrix.trans.  With one block of four warps on an SM, a tile's
//   arithmetic sits between the copies and the output, so instructions per
//   element decide: the CUDA cores take about four per K or V element (a
//   conversion and an FMA each way, plus the shuffles), the tensor cores
//   about one per 60, padded rows and all; at G = 1 the tensor-core kernel
//   measured faster at phi-3's shape.
// * decode_split_cc_kernel<HD, GM> (f32 at every G: the reduced
//   families the profiler measures, and the f32 parity checks): CUDA cores,
//   so f32 inputs are never rounded.  LPS lanes share a slot, each owning a
//   contiguous piece of hd for all GM heads of its row chunk (q and the
//   accumulator in registers, so each K and V element is read from shared
//   memory once for all GM heads); the dots are summed over the LPS lanes
//   with shuffles.  GM is G rounded up to 1, 2, 4 or 8; a larger G runs
//   its heads in row chunks of 8 along the grid's y axis.
//
// Semantics are the reference's: a slot at or past lengths[b] scores
// -1e30.  With lengths[b] > 0 the block computes only slots below
// n = min(lengths[b], L), all of them valid; with lengths[b] <= 0 it reads
// all L, each scoring -1e30, so every split's max is -1e30, the combine
// weighs all slots alike and the output is the mean of V.  A split whose
// range starts at or past n writes m = -inf, l = 0 and the combine gives
// it weight 0 without forming exp(-inf - (-inf)).  p is rounded to V's
// dtype before P V against the sub-state's running max; l sums the
// unrounded p; l == 0 divides by 1.  The output is in q's dtype.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;                  // threads a block: four warps
constexpr int BK = 64;                   // slots a ring stage (16 a warp in the tensor-core kernel)
constexpr int MAX_STAGES = 4;
constexpr int RING_BYTES = 144 * 1024;   // the most shared memory a ring may take
constexpr int SPLITS_AT_ONCE = 8;        // splits whose partials the combine loads together

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* ws_acc;   // (B * H, splits, HD) f32 partial accumulators
  float* ws_ml;    // (B * H, splits, 2) f32 partial row max and row sum
  int* counters;   // one arrival counter per (batch, KV head, row chunk), zero between calls
  int L, H, KV, G, splits, chunk, stages;
  float scale;
};

// The (batch, KV head, row chunk) of this block, and the slot range it reads.
struct Block {
  int b, kvh, rows, head0, cidx;
  int s0, s1;    // slots [s0, s1); s1 <= s0 for a split that computes nothing
  bool masked;   // lengths[b] <= 0: every slot scores -1e30
};

template <int GM>
__device__ __forceinline__ Block block_of(const Args& a) {
  Block k;
  k.b = blockIdx.z;
  const int nch = gridDim.y / a.KV;
  k.kvh = blockIdx.y / nch;
  const int row0 = (blockIdx.y % nch) * GM;
  k.rows = min(GM, a.G - row0);
  k.head0 = k.b * a.H + k.kvh * a.G + row0;
  k.cidx = k.b * gridDim.y + blockIdx.y;
  k.s0 = blockIdx.x * a.chunk;
  return k;
}

// `len` is lengths[b], loaded ahead of the cache copies: behind them it
// would arrive last.
__device__ __forceinline__ void read_length(const Args& a, Block& k, int len) {
  const int n = len > 0 ? min(len, a.L) : a.L;
  k.masked = len <= 0;
  k.s1 = min(k.s0 + a.chunk, n);
}

// Copy the cache slots [k0, k0 + BK) of one KV head into shared rows of LD
// elements; rows at or past `end` are zero-filled.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(T* sk, T* sv, const T* kb, const T* vb, int64_t row,
                                          int k0, int end) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PPR = HD / VEC;   // 16-byte pieces a slot
#pragma unroll
  for (int e = threadIdx.x; e < BK * PPR; e += NT) {
    const int r = e / PPR, c = (e % PPR) * VEC;
    const bool in = k0 + r < end;
    const int64_t off = in ? (k0 + r) * row + c : 0;
    repro::cp_async16(sk + r * LD + c, kb + off, in);
    repro::cp_async16(sv + r * LD + c, vb + off, in);
  }
}

// The ring: stage i of `stages` holds tiles i, i + stages, ...  One copy
// group is committed per tile (an empty one past the split), so tile `it`
// has landed once at most stages - 1 groups are in flight.
template <typename T, int HD, int LD>
struct Ring {
  T* sk;
  T* sv;
  const T* kb;
  const T* vb;
  int64_t row;
  int stages;

  __device__ __forceinline__ T* k_stage(int it) const { return sk + (it % stages) * BK * LD; }
  __device__ __forceinline__ T* v_stage(int it) const { return sv + (it % stages) * BK * LD; }

  // Every stage's first tile, issued before lengths[b] is known: copied up
  // to the end of the split or of the cache.
  __device__ __forceinline__ void start(const Args& a, const Block& k) const {
    const int end = min(k.s0 + a.chunk, a.L);
    for (int i = 0; i < stages; ++i) {
      if (k.s0 + i * BK < end) load_tile<T, HD, LD>(k_stage(i), v_stage(i), kb, vb, row,
                                                    k.s0 + i * BK, end);
      repro::cp_async_commit();
    }
  }
  __device__ __forceinline__ void wait() const {
    switch (stages) {
      case 1: repro::cp_async_wait<0>(); break;
      case 2: repro::cp_async_wait<1>(); break;
      case 3: repro::cp_async_wait<2>(); break;
      default: repro::cp_async_wait<3>(); break;
    }
    __syncthreads();
  }
  // After tile `it` is computed: its stage takes tile it + stages.
  __device__ __forceinline__ void refill(const Block& k, int it, int nt) const {
    __syncthreads();   // every warp is done with the stage
    if (it + stages < nt)
      load_tile<T, HD, LD>(k_stage(it), v_stage(it), kb, vb, row, k.s0 + (it + stages) * BK, k.s1);
    repro::cp_async_commit();
  }
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

// The block's NSUB sub-states lie in shared memory, each an online softmax
// over its own slots: NSUB x GM row maxima, then NSUB x GM row sums, then
// NSUB x GM accumulator rows of stride LDA.  Merge them for the block's
// rows; with one split write the output, else write the block's partial,
// and let the last block of the (batch, KV head, row chunk) combine all
// partials.
template <int GM, int NSUB, int LDA>
__host__ __device__ constexpr int merge_floats() {
  return NSUB * GM * (2 + LDA) + NSUB * GM + 3 * GM;   // sub-states, weights, m, l, 1 / l
}

// Four neighbouring outputs in T.
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(repro::pack_bf16(x.x, x.y), repro::pack_bf16(x.z, x.w));
}

template <typename T, int HD, int GM, int NSUB, int LDA>
__device__ __forceinline__ void finish(float* sm, const Args& a, const Block& k) {
  using namespace repro;
  static_assert(NSUB <= 32, "a warp merges a row");
  const float* sm_m = sm;
  const float* sm_l = sm + NSUB * GM;
  const float* sm_acc = sm + 2 * NSUB * GM;
  float* sw = sm + NSUB * GM * (2 + LDA);   // NSUB x GM weights exp(m_s - m)
  float* srow = sw + NSUB * GM;             // the block's m, l and 1 / l of each row
  T* o = static_cast<T*>(a.o);
  const bool empty = k.s1 <= k.s0;
  // A warp a row: the sub-states' weights (those that saw no slot hold
  // m = -1e30, l = 0, acc = 0) and the row's m and l.
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < k.rows && !empty; r += NT / 32) {
    const float ms = lane < NSUB ? sm_m[lane * GM + r] : kMasked;
    const float m = group_max<32>(ms);
    const float w = lane < NSUB ? expf(ms - m) : 0.f;
    const float l = group_sum<32>(lane < NSUB ? w * sm_l[lane * GM + r] : 0.f);
    if (lane < NSUB) sw[lane * GM + r] = w;
    if (lane == 0) {
      srow[3 * r] = m;
      srow[3 * r + 1] = l;
      srow[3 * r + 2] = 1.f / (l == 0.f ? 1.f : l);
    }
  }
  __syncthreads();
  // Four neighbouring elements of a row a thread, every load independent.
  constexpr int Q4 = HD / 4;
  constexpr int EPT = (GM * Q4 + NT - 1) / NT;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * NT, r = e / Q4, d = (e % Q4) * 4;
    if (r >= k.rows) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!empty) {
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
        const float w = sw[s * GM + r];
        const float4 x = *reinterpret_cast<const float4*>(sm_acc + (s * GM + r) * LDA + d);
        acc.x = fmaf(w, x.x, acc.x);
        acc.y = fmaf(w, x.y, acc.y);
        acc.z = fmaf(w, x.z, acc.z);
        acc.w = fmaf(w, x.w, acc.w);
      }
    }
    if (a.splits == 1) {
      const float inv = srow[3 * r + 2];
      store4(o + (int64_t)(k.head0 + r) * HD + d,
             make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
      continue;
    }
    const int64_t p = (int64_t)(k.head0 + r) * a.splits + blockIdx.x;
    if (!empty) store4(a.ws_acc + p * HD + d, acc);
    if (d == 0) {
      a.ws_ml[2 * p] = empty ? -INFINITY : srow[3 * r];
      a.ws_ml[2 * p + 1] = empty ? 0.f : srow[3 * r + 1];
    }
  }
  if (a.splits == 1) return;

  // Count this block in.  The barrier orders every thread's partial before
  // thread 0's release; its acquire orders the other blocks' partials
  // before the combine's loads (both carried to the block by the barriers).
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    last = arrive(a.counters + k.cidx) == a.splits - 1;
    if (last) a.counters[k.cidx] = 0;   // every block has counted: ready for the next call
  }
  __syncthreads();
  if (!last) return;

  // The last block combines: each thread four neighbouring elements of a
  // row, an online softmax over the splits, SPLITS_AT_ONCE splits' (m, l)
  // and acc loaded together.  A split past n has m = -inf: weight 0, and
  // its acc (never written) is selected away, not multiplied.
  const float2* ml = reinterpret_cast<const float2*>(a.ws_ml);
  const float4* wa = reinterpret_cast<const float4*>(a.ws_acc);
  for (int e = threadIdx.x; e < k.rows * Q4; e += NT) {
    const int64_t p0 = (int64_t)(k.head0 + e / Q4) * a.splits;
    float m = -INFINITY, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < a.splits; s0 += SPLITS_AT_ONCE) {
      float2 x[SPLITS_AT_ONCE];
      float4 y[SPLITS_AT_ONCE];
#pragma unroll
      for (int u = 0; u < SPLITS_AT_ONCE; ++u) {
        const bool in = s0 + u < a.splits;
        x[u] = in ? __ldcg(ml + p0 + s0 + u) : make_float2(-INFINITY, 0.f);
        y[u] = in ? __ldcg(wa + (p0 + s0 + u) * Q4 + e % Q4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mb = m;   // split 0 starts below n, so mb is finite from the first round on
#pragma unroll
      for (int u = 0; u < SPLITS_AT_ONCE; ++u) mb = fmaxf(mb, x[u].x);
      const float alpha = expf(m - mb);
      l *= alpha;
      acc.x *= alpha, acc.y *= alpha, acc.z *= alpha, acc.w *= alpha;
#pragma unroll
      for (int u = 0; u < SPLITS_AT_ONCE; ++u) {
        if (x[u].x == -INFINITY) continue;
        const float w = expf(x[u].x - mb);
        l = fmaf(w, x[u].y, l);
        acc.x = fmaf(w, y[u].x, acc.x);
        acc.y = fmaf(w, y[u].y, acc.y);
        acc.z = fmaf(w, y[u].z, acc.z);
        acc.w = fmaf(w, y[u].w, acc.w);
      }
      m = mb;
    }
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    store4(o + (p0 / a.splits) * HD + (e % Q4) * 4,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: f32 at every G.  LPS lanes share a slot; lane j of a lane
// group owns the CH = HD / LPS elements [j CH, j CH + CH) of every K and V
// row for all GM heads.  Group g of NG takes the slots u NG + g of a 64-slot
// stage, so a warp reads whole rows of consecutive slots.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int lanes_per_slot(int hd, int gm) {
  int lps = 8;   // fewest lanes that keep q and the accumulator at <= 32 registers each
  while (lps < 32 && gm * (hd / lps) > 32) lps *= 2;
  return lps;
}

template <int HD>
__host__ __device__ constexpr int cc_stage_bytes() {
  return 2 * BK * HD * (int)sizeof(float);   // K and V
}

template <int HD, int GM>
__host__ __device__ constexpr int cc_merge_bytes() {
  return merge_floats<GM, NT / lanes_per_slot(HD, GM), HD>() * (int)sizeof(float);
}

// CH contiguous floats from shared memory, in the widest loads their
// alignment allows (a lane's piece starts at a multiple of CH).
template <int CH>
__device__ __forceinline__ void load_piece(const float* p, float (&f)[CH]) {
  if constexpr (CH % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CH / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = x.x;
      f[4 * i + 1] = x.y;
      f[4 * i + 2] = x.z;
      f[4 * i + 3] = x.w;
    }
  } else if constexpr (CH % 2 == 0) {
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(p)[i];
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CH; ++i) f[i] = p[i];
  }
}

template <int HD, int GM>
__global__ void __launch_bounds__(NT)
decode_split_cc_kernel(Args a) {
  using namespace repro;
  constexpr int LPS = lanes_per_slot(HD, GM);
  constexpr int CH = HD / LPS;
  constexpr int NG = NT / LPS;                // lane groups
  constexpr int SPG = BK / NG;                // slots of a stage for each group
  constexpr int SU = SPG < 4 ? SPG : 4;       // slots per online-softmax step
  static_assert(HD % LPS == 0 && BK % NG == 0, "lane layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  Block k = block_of<GM>(a);
  const int grp = threadIdx.x / LPS, j = threadIdx.x % LPS;
  const int64_t row = (int64_t)a.KV * HD;     // one cache slot
  const int64_t base = (int64_t)k.b * a.L * row + (int64_t)k.kvh * HD;
  const int len = a.lengths[k.b];
  float qr[GM][CH];
  const float* qb = static_cast<const float*>(a.q) + (int64_t)k.head0 * HD + j * CH;
#pragma unroll
  for (int r = 0; r < GM; ++r)
#pragma unroll
    for (int c = 0; c < CH; ++c) qr[r][c] = r < k.rows ? qb[r * HD + c] : 0.f;
  float* sk = reinterpret_cast<float*>(smem_raw);
  const Ring<float, HD, HD> ring{sk, sk + a.stages * BK * HD, static_cast<const float*>(a.k) + base,
                                 static_cast<const float*>(a.v) + base, row, a.stages};
  ring.start(a, k);
  read_length(a, k, len);
  const int nt = k.s1 > k.s0 ? (k.s1 - k.s0 + BK - 1) / BK : 0;

  float m[GM], l[GM], acc[GM][CH];
#pragma unroll
  for (int r = 0; r < GM; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[r][c] = 0.f;
  }

  for (int it = 0; it < nt; ++it) {
    ring.wait();
    const float* ks = ring.k_stage(it);
    const float* vs = ring.v_stage(it);
    const int k0 = k.s0 + it * BK;
#pragma unroll
    for (int u0 = 0; u0 < SPG; u0 += SU) {
      float sc[SU][GM];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        float kf[CH];
        load_piece<CH>(ks + ((u0 + u) * NG + grp) * HD + j * CH, kf);
#pragma unroll
        for (int r = 0; r < GM; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < CH; ++c) dot = fmaf(qr[r][c], kf[c], dot);
          sc[u][r] = group_sum<LPS>(dot);
        }
      }
      // slots at or past s1 (those copied before lengths[b] arrived
      // included) add nothing
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const bool in = k0 + (u0 + u) * NG + grp < k.s1;
#pragma unroll
        for (int r = 0; r < GM; ++r)
          sc[u][r] = in ? (k.masked ? kMasked : sc[u][r] * a.scale) : -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < GM; ++r) {
        float mx = sc[0][r];
#pragma unroll
        for (int u = 1; u < SU; ++u) mx = fmaxf(mx, sc[u][r]);
        const float mn = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[r][c] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int i = (u0 + u) * NG + grp;
        if (k0 + i >= k.s1) continue;   // the same for every lane of the group
        float vf[CH];
        load_piece<CH>(vs + i * HD + j * CH, vf);
#pragma unroll
        for (int r = 0; r < GM; ++r) {
          const float p = expf(sc[u][r] - m[r]);
          l[r] += p;
#pragma unroll
          for (int c = 0; c < CH; ++c) acc[r][c] = fmaf(p, vf[c], acc[r][c]);
        }
      }
    }
    ring.refill(k, it, nt);
  }
  cp_async_wait<0>();   // copies of stages past n may still be in flight
  __syncthreads();

  float* sm = reinterpret_cast<float*>(smem_raw);   // the ring is free again
#pragma unroll
  for (int r = 0; r < GM; ++r) {
    if (j == 0) {
      sm[grp * GM + r] = m[r];
      sm[NG * GM + grp * GM + r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) sm[2 * NG * GM + (grp * GM + r) * HD + j * CH + c] = acc[r][c];
  }
  __syncthreads();
  finish<float, HD, GM, NG, HD>(sm, a, k);
}

// ---------------------------------------------------------------------------
// Tensor cores: bf16 at every G.  The group padded to 16 rows; warp w takes
// slots 16w .. 16w+15 of each 64-slot tile.  Fragment layouts as in mma.cuh
// (g = lane / 4, t = lane % 4): this thread holds rows g and g + 8.
// ---------------------------------------------------------------------------
template <int HD>
__host__ __device__ constexpr int tc_stage_bytes() {
  return 2 * BK * (HD + 8) * (int)sizeof(bf16);   // K and V, rows padded by 16 bytes
}

template <int HD>
__host__ __device__ constexpr int tc_merge_bytes() {
  return merge_floats<16, 4, HD + 8>() * (int)sizeof(float);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool in) {
  return in ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

template <int HD>
__global__ void __launch_bounds__(NT)
decode_split_tc_kernel(Args a) {
  using namespace repro;
  constexpr int LD = HD + 8;   // 16-byte pad: the 8 rows of an ldmatrix tile hit 8 bank groups
  constexpr int KS = HD / 16;  // k-steps of Q K^T; also 16-wide column pairs of P V
  constexpr int DT = HD / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];

  Block k = block_of<16>(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t row = (int64_t)a.KV * HD;
  const int64_t base = (int64_t)k.b * a.L * row + (int64_t)k.kvh * HD;
  // lengths[b] and Q's A fragments straight from device memory, ahead of
  // the cache copies; rows past the group are 0
  const int len = a.lengths[k.b];
  uint32_t qf[KS][4];
  const bf16* qb = static_cast<const bf16*>(a.q) + (int64_t)k.head0 * HD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qf[kk][0] = load_pair(qb + g * HD + kk * 16, g < k.rows);
    qf[kk][1] = load_pair(qb + (g + 8) * HD + kk * 16, g + 8 < k.rows);
    qf[kk][2] = load_pair(qb + g * HD + kk * 16 + 8, g < k.rows);
    qf[kk][3] = load_pair(qb + (g + 8) * HD + kk * 16 + 8, g + 8 < k.rows);
  }
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  const Ring<bf16, HD, LD> ring{sk, sk + a.stages * BK * LD, static_cast<const bf16*>(a.k) + base,
                                static_cast<const bf16*>(a.v) + base, row, a.stages};
  ring.start(a, k);
  read_length(a, k, len);
  const int nt = k.s1 > k.s0 ? (k.s1 - k.s0 + BK - 1) / BK : 0;

  float acc[DT][4];
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int it = 0; it < nt; ++it) {
    ring.wait();
    const bf16* ks = ring.k_stage(it);
    bf16* vs = ring.v_stage(it);
    const int k0 = k.s0 + it * BK;
    const int copied = min(BK, min(k.s0 + a.chunk, a.L) - k0);
    if (it < a.stages && k.s1 - k0 < copied) {
      // a tile copied before lengths[b] arrived: its V rows in [n, L) could
      // hold anything, and 0 * inf is NaN in the product, so zero them
      for (int e = threadIdx.x; e < (copied - (k.s1 - k0)) * (HD / 2); e += NT)
        reinterpret_cast<uint32_t*>(vs + (k.s1 - k0 + e / (HD / 2)) * LD)[e % (HD / 2)] = 0u;
      __syncthreads();
    }
    const int w0 = k0 + warp * 16;   // the warp's first slot
    if (w0 < k.s1) {
      // even and odd k-steps into two accumulators: two chains of dependent
      // products, not one
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float s_odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (warp * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16
                           + ((lane / 8) % 2) * 8);
        mma_bf16(kk % 2 ? s_odd[0] : s[0], qf[kk], r[0], r[1]);
        mma_bf16(kk % 2 ? s_odd[1] : s[1], qf[kk], r[2], r[3]);
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) add_frag(s[jn], s_odd[jn]);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = w0 + 8 * jn + 2 * t + (e & 1) < k.s1;
          s[jn][e] = in ? (k.masked ? kMasked : s[jn][e] * a.scale) : -INFINITY;
        }

      // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3), a quad a row
      float mx[2] = {fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])),
                     fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]))};
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], group_max<4>(mx[r]));
        alpha[r] = expf(m[r] - mn);
        m[r] = mn;
      }
      uint32_t pf[4];   // P as the A operand: (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const float p0 = expf(s[jn][0] - m[0]), p1 = expf(s[jn][1] - m[0]);
        const float p2 = expf(s[jn][2] - m[1]), p3 = expf(s[jn][3] - m[1]);
        sum[0] += p0 + p1;
        sum[1] += p2 + p3;
        pf[2 * jn] = pack_bf16(p0, p1);
        pf[2 * jn + 1] = pack_bf16(p2, p3);
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
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD
                                 + dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pf, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pf, r[2], r[3]);
      }
    }
    ring.refill(k, it, nt);
  }
  cp_async_wait<0>();
  __syncthreads();

  // accumulator rows padded to HD + 8 floats: the float2 stores of a half
  // warp fall on 32 distinct banks
  constexpr int LDA = HD + 8;
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* sm_acc = sm + 2 * 4 * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rw = warp * 16 + g + 8 * r;
    if (t == 0) {
      sm[rw] = m[r];
      sm[4 * 16 + rw] = l[r];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(sm_acc + rw * LDA + 8 * d + 2 * t) =
          make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
  }
  __syncthreads();
  finish<bf16, HD, 16, 4, LDA>(sm, a, k);
}

// ---------------------------------------------------------------------------
// Which kernel a call takes, its ring and shared memory, and its launch
// ---------------------------------------------------------------------------
using Kernel = void (*)(Args);

struct Plan {
  Kernel kernel;
  int stage_bytes;   // K and V of one ring stage
  int merge_bytes;   // the sub-states at the end
  int gm;            // heads a block: grid y is KV * ceil(G / gm)

  // Stages of a split of `chunk` slots: as many as its tiles, at most
  // MAX_STAGES and RING_BYTES, at least one.
  int stages(int chunk) const {
    int s = RING_BYTES / stage_bytes;
    s = s < MAX_STAGES ? s : MAX_STAGES;
    s = s < chunk / BK ? s : chunk / BK;
    return s > 1 ? s : 1;
  }
  int smem(int chunk) const {
    const int ring = stages(chunk) * stage_bytes;
    return ring > merge_bytes ? ring : merge_bytes;
  }
};

template <int HD, int GM>
Plan cc_plan() {
  return {decode_split_cc_kernel<HD, GM>, cc_stage_bytes<HD>(), cc_merge_bytes<HD, GM>(), GM};
}

template <int HD>
Plan plan_hd(int G, int is_bf16) {
  if (is_bf16) return {decode_split_tc_kernel<HD>, tc_stage_bytes<HD>(), tc_merge_bytes<HD>(), 16};
  if (G == 1) return cc_plan<HD, 1>();
  if (G == 2) return cc_plan<HD, 2>();
  if (G <= 4) return cc_plan<HD, 4>();
  return cc_plan<HD, 8>();
}

Plan plan(int G, int HD, int is_bf16) {
  switch (HD) {
    case 32: return plan_hd<32>(G, is_bf16);
    case 64: return plan_hd<64>(G, is_bf16);
    case 96: return plan_hd<96>(G, is_bf16);
    case 128: return plan_hd<128>(G, is_bf16);
    default: return {nullptr, 1, 0, 0};
  }
}

// Allow every kernel the dynamic shared memory of its deepest ring, once:
// the first call sets all of them.
cudaError_t configure_all() {
  const int dims[] = {32, 64, 96, 128};
  const int groups[] = {1, 2, 4, 8};
  for (int hd : dims)
    for (int bf = 0; bf < 2; ++bf)
      for (int G : groups) {
        const Plan p = plan(G, hd, bf);
        cudaError_t err = cudaFuncSetAttribute(
            p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem(MAX_STAGES * BK));
        if (err != cudaSuccess) return err;
      }
  return cudaSuccess;
}

}  // namespace

// Ring stages and dynamic shared memory (bytes) of one block for a GQA
// group of G heads at head dim HD, dtype and `chunk` slots a split (0 for
// an unsupported HD).
extern "C" int repro_decode_attention_stages(int G, int HD, int is_bf16, int chunk) {
  const Plan p = plan(G, HD, is_bf16);
  return p.kernel ? p.stages(chunk) : 0;
}

extern "C" int repro_decode_attention_smem_bytes(int G, int HD, int is_bf16, int chunk) {
  const Plan p = plan(G, HD, is_bf16);
  return p.kernel ? p.smem(chunk) : 0;
}

// Resident blocks per SM of that launch, from the occupancy calculator; a
// negative value is a cudaError_t.
extern "C" int repro_decode_attention_blocks_per_sm(int G, int HD, int is_bf16, int chunk) {
  const Plan p = plan(G, HD, is_bf16);
  if (!p.kernel) return -(int)cudaErrorInvalidValue;
  static cudaError_t configured = configure_all();
  if (configured != cudaSuccess) return -(int)configured;
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, p.kernel, NT, p.smem(chunk));
  return err == cudaSuccess ? n : -(int)err;
}

// q, o: (B, H, HD); k_cache, v_cache: (B, L, KV, HD); lengths: (B,) int32;
// all contiguous, on the current device, caches 16-byte aligned.  ws: f32
// scratch of B * H * splits * (HD + 2) (unused when splits == 1);
// counters: int32, zero, at least B * H of them.  Slots [s chunk, s chunk +
// chunk) go to split s; splits * chunk >= L and chunk is a multiple of 64.
// Returns the launch's cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const void* lengths, void* o, void* ws, void* counters,
                                      int B, int L, int H, int KV, int HD, int is_bf16,
                                      float scale, int splits, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || splits <= 0 || chunk <= 0
      || chunk % BK != 0 || (int64_t)splits * chunk < L || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const Plan p = plan(G, HD, is_bf16);
  if (!p.kernel) return (int)cudaErrorInvalidValue;
  static cudaError_t configured = configure_all();
  if (configured != cudaSuccess) return (int)configured;
  float* wsf = static_cast<float*>(ws);
  Args a{q, k_cache, v_cache, static_cast<const int*>(lengths), o, wsf,
         wsf ? wsf + (int64_t)B * H * splits * HD : nullptr, static_cast<int*>(counters),
         L, H, KV, G, splits, chunk, p.stages(chunk), scale};
  dim3 grid(splits, KV * ((G + p.gm - 1) / p.gm), B);
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(p.kernel), grid, dim3(NT),
                                     params, p.smem(chunk), static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
