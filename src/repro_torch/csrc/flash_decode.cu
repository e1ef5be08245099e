// One query token per sequence against a KV cache (decode attention).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py::
// flash_decode (body _decode_kernel): for batch b and KV head kv, the
// G = H / KV query heads h = kv*G + g share the cache's head kv, and
//     s[t] = (q[b,h,:] . k[b,t,kv,:]) * scale,  scale = 1/sqrt(d),
//     s[t] = -1e30 where t >= cache_len[b],
//     out[b,h,:] = (sum_t exp(s[t] - m) v[b,t,kv,:]) / max(sum_t exp(s[t] - m), 1e-30)
// with the softmax in float32 whatever the input type (float32 or
// bfloat16), and the output in the input type.  cache_len <= 0 makes every
// score -1e30, every weight exp(0) = 1, and the output the mean of V over
// all T positions, as in the reference.
//
// Bound on the H100: the kernel must read q and the live part of the
// cache once (K and V, or V alone where cache_len <= 0) and write out;
// 4*d operations per query head and live position.  At every shape of the
// repo's paths that is below the card's ridge, so bytes bound it: e.g.
// (B, H, KV, d, T) = (8, 40, 10, 128, 32768) with mixed lengths moves
// 0.68 GB in bfloat16, 0.20 ms at 3.35 TB/s.  The exception is a wide
// float32 group such as granite-20b's MQA (48 query heads on one KV head),
// where the float32 FMAs (67 TFLOP/s) bound it.  The products stay on the
// CUDA cores: a product of G <= 16 rows gains little from the tensor cores
// while bytes bound it (mma.sync on bf16 for G >= 16 is later work).
//
// Design, against that bound (a first version ran one block of 4 warps a
// (b, KV head) through its whole cache in synchronous tiles, with one
// thread a head for the softmax: 4 blocks at the MQA row, ~9 us a tile):
// * The cache's length is split across blocks.  One block takes one
//   (b, KV head, group of at most 4 query heads, split); the ns splits of
//   a (b, KV head, group) form one thread-block cluster.  The caller picks
//   ns (kernels/flash_decode/kernel.py::decode_splits): enough blocks for
//   half the SMs, or one split per 1,024 positions of T where that is
//   more, at most 8 (a portable cluster) and ceil(T / 32).  A short cache
//   keeps its grid in one wave; a long one gets every split.
// * Each block reads cache_len[b] itself and takes its share of the live
//   range [0, live) (live = min(cache_len, T), or T where cache_len <= 0):
//   split i covers [i*p, min((i+1)*p, live)), p = ceil(live / ns).  The
//   splits follow the live length, whatever T is; a split whose range is
//   empty (more splits than live positions) does no work.  Positions at or
//   past cache_len are never read; with cache_len <= 0 every split reads V
//   and skips K (every score is -1e30).
// * Each split keeps, per head, the running maximum m, sum l and the
//   float32 accumulator acc of an online softmax over its range.  After a
//   cluster barrier the cluster combines them exactly through distributed
//   shared memory, each block a share of the group's outputs:
//       out = sum_i exp(m_i - M) acc_i / max(sum_i exp(m_i - M) l_i, 1e-30),
//   M = max_i m_i over the splits that did work.  One launch a call, no
//   scratch in device memory, nothing to reset: safe under CUDA-graph
//   capture and on several streams.
// * A producer warp streams the range in tiles of 32 positions (64 in
//   bf16: the same bytes) into a ring of 2-8 stages by 16-byte cp.async
//   copies in the cache's own type (a bf16 tile stays bf16 and is
//   converted in registers); a stage's "full"
//   mbarrier completes when its copies land (cp.async.mbarrier.arrive),
//   its "empty" one when the 8 consumer warps are done with it.  So no
//   copy is issued on the consumers' path.  The ring is sized so that two
//   blocks fit on an SM where the width allows.  K rows sit at a stride of
//   4*odd words, so the score loads are free of bank conflicts.
// * Scores: lane j of every consumer warp takes positions j (and j + 32
//   in bf16) of the tile, each warp an eighth of d for all the block's
//   heads (one K load and conversion serves every head); the eighths meet
//   in shared memory, and one warp a head runs its online softmax in log2
//   units (exp2, log2(e) folded into the scale; the warp's maximum by one
//   integer reduction).
//   Values: each thread owns 8 columns of the block's heads over a share
//   of the tile's positions, in registers; the shares are summed once, at
//   the end of the walk.  Two consumer barriers a tile.
// * Groups wider than 4 heads (qwen2.5-32b's 5, granite-20b's 48) are cut
//   into equal head groups of at most 4, a block each: more blocks, and
//   less work a tile, than one wide block; their repeated K/V reads come
//   from L2.  A block computes 1 head or 4 (q rows past its own are
//   zero), so the head loops carry no branch.
// The cache is read through its strides, so a [B, T, KV, d] cache is never
// transposed.  d must be a multiple of 8, at most 256.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                // consumer warps: scores, softmax, values
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32; // and one producer warp: the copies
constexpr int kMaxGroup = 4;            // query heads a block
constexpr int kMaxSplits = 8;           // blocks a cluster (the portable maximum)
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 112 * 1024; // so that two blocks fit the SM's 228 KB
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// Cache positions a tile: one a lane in float32, two in bfloat16, so that a
// tile's rows hold the same bytes in both.
__host__ __device__ constexpr int tile_of(int es) { return es == 2 ? 64 : 32; }

// Heads a block: groups above 4 heads are cut into equal head groups (as
// kernels/flash_decode/kernel.py::head_groups counts them for its split
// rule).
__host__ __device__ inline int head_groups(int G) { return cdiv(G, kMaxGroup); }
__host__ __device__ inline int group_width(int G) { return cdiv(G, head_groups(G)); }

// Shared memory of one block, in bytes from its start, for a group of
// gmax heads (rows past the block's own heads are zero).  The ring of K/V
// stages comes first; after the walk it holds the split's accumulators.
struct Plan {
  int ldk;          // K row stride in elements: 4*odd words
  int k_bytes;      // one stage's K tile
  int stage_bytes;  // one stage: K tile, then V tile
  int nc;           // chunks of 8 columns in a row
  int ps;           // position subsets in the value phase
  int off_q, off_s, off_p, off_alpha, off_ml, off_w, off_bar, total;
};

__host__ __device__ inline Plan make_plan(int d, int gmax, int es, int stages) {
  Plan p;
  const int words = d * es / 4;                         // a multiple of 4
  p.ldk = words % 8 == 0 ? d + 16 / es : d;
  const int tile = tile_of(es);
  p.k_bytes = tile * p.ldk * es;
  p.stage_bytes = p.k_bytes + tile * d * es;
  p.nc = d / 8;
  p.ps = min(kConsumers / p.nc, tile);                  // thread rows of the value phase
  int ring = stages * p.stage_bytes;
  const int acc_bytes = 4 * p.ps * gmax * d;
  if (ring < acc_bytes) ring = acc_bytes;
  p.off_q = ring;                                       // [gmax][d] float
  p.off_s = p.off_q + 4 * gmax * d;                     // [kWarps][gmax][tile] partial scores
  p.off_p = p.off_s + 4 * kWarps * gmax * tile;         // [gmax][tile + 1] weights
  p.off_alpha = p.off_p + 4 * gmax * (tile + 1);        // [gmax]
  p.off_ml = p.off_alpha + 4 * gmax;                    // [2][gmax]: m, then l
  p.off_w = p.off_ml + 8 * gmax;                        // [gmax][kMaxSplits] combine weights
  p.off_bar = (p.off_w + 4 * gmax * kMaxSplits + 7) / 8 * 8;   // full[stages], empty[stages]
  p.total = p.off_bar + 16 * kMaxStages;
  return p;
}

// The ring's depth: as many stages as the budget holds beside the rest,
// 2 to 8.
inline int choose_stages(int d, int gmax, int es) {
  const Plan one = make_plan(d, gmax, es, 1);
  const int fixed = one.total - one.off_q;
  const int stages = (kSmemBudget - fixed) / one.stage_bytes;
  return stages < 2 ? 2 : stages > kMaxStages ? kMaxStages : stages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n .reg .pred done;\n"
               "WAIT_%=:\n"
               " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               " @!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// 16 bytes global -> shared through the LSU, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
// One arrival on `bar` once this thread's earlier cp.async copies are in.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// The consumer warps' own barrier (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 8 consecutive elements as float32.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {                 // a bf16 is the top half of its float32
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// The warp's largest float, by one integer reduction: flipping a negative
// float's low 31 bits makes the integer order the float order.
__device__ __forceinline__ float warp_max(float x) {
  int i = __float_as_int(x);
  i ^= (i >> 31) & 0x7fffffff;
  i = __reduce_max_sync(0xffffffffu, i);
  i ^= (i >> 31) & 0x7fffffff;
  return __int_as_float(i);
}

// GMAX: the heads a block computes (1, or 4 for groups of 2 to 4; rows
// past the group's own are zero rows of q and are never stored).  DMAX:
// the head-dim bound (128 or 256) that sizes the score phase's unrolled
// chunks.  Two blocks an SM: 96 registers a thread.
template <typename T, int GMAX, int DMAX>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    int Tc, int H, int KV, int d, int stages,
                    long long q_sb, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh, float scale) {
  constexpr int CPW = DMAX / (8 * kWarps);               // score chunks a warp
  constexpr int TILE = tile_of(sizeof(T));
  constexpr int PPL = TILE / 32;                         // positions a lane
  // the score chunks, unrolled but in bf16 at d <= 128, where a lane's two
  // positions already overlap and ptxas spills the unrolled loop at 96
  // registers (while at d <= 256 it spills the rolled one)
  constexpr int CHUNK_UNROLL = PPL == 2 && DMAX == 128 ? 1 : CPW;
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int G = H / KV, n_hg = head_groups(G), gb = group_width(G);
  const int unit = blockIdx.x / ns;             // (b, kv, head group)
  const int hg = unit % n_hg, bkv = unit / n_hg;
  const int b = bkv / KV, kvh = bkv - b * KV;
  const int g0 = hg * gb;
  const int gn = min(gb, G - g0);               // heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Plan P = make_plan(d, GMAX, static_cast<int>(sizeof(T)), stages);
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + P.off_q);
  float* sS = reinterpret_cast<float*>(smem + P.off_s);
  float* sP = reinterpret_cast<float*>(smem + P.off_p);
  float* sAlpha = reinterpret_cast<float*>(smem + P.off_alpha);
  float* sML = reinterpret_cast<float*>(smem + P.off_ml);
  float* sW = reinterpret_cast<float*>(smem + P.off_w);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P.off_bar);  // a stage's copies are in
  uint64_t* empty = full + kMaxStages;          // a stage is read by every consumer warp
  float* sAcc = reinterpret_cast<float*>(smem);  // after the walk

  const float scale2 = scale * 1.4426950408889634f;   // scores in log2 units
  // this split's share of the live range
  const int len = cache_len[b];
  const bool scored = len > 0;
  const int live = scored ? min(len, Tc) : Tc;
  const int per = cdiv(live, ns);
  const int start = min(split * per, live), end = min(start + per, live);
  const int ntiles = cdiv(end - start, TILE);

  const T* kb = kc + b * k_sb + kvh * k_sh;
  const T* vb = vc + b * v_sb + kvh * v_sh;
  auto stage_k = [&](int s) { return reinterpret_cast<T*>(smem + s * P.stage_bytes); };
  auto stage_v = [&](int s) { return reinterpret_cast<T*>(smem + s * P.stage_bytes + P.k_bytes); };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);                  // the producer's 32 lanes
      mbar_init(&empty[s], kWarps);             // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // softmax: warp g < GMAX runs head g
  float m_run = __int_as_float(0xff800000), l_run = 0.f;
  // values: consumer thread -> 8 columns from c8 of every head, over
  // positions pset + i * ps
  const int c8 = (tid % P.nc) * 8, pset = tid / P.nc;
  const bool active = warp < kWarps && pset < P.ps;
  float acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  if (warp == kWarps) {
    // producer: each tile into its ring stage once the consumers have read
    // the stage's last tile; lane l copies rows l / 4 + 8 i, every fourth
    // 16-byte chunk from chunk l % 4 (64 contiguous bytes a row a copy)
    constexpr int epc = 16 / sizeof(T);         // elements a copy
    const int r0 = lane >> 2, c0 = (lane & 3) * epc;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % stages, t0 = start + it * TILE, n = min(TILE, end - t0);
      if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
      T* sk = stage_k(s);
      T* sv = stage_v(s);
      for (int r = r0; r < n; r += 8) {
        const T* ks = kb + (t0 + r) * k_st;
        const T* vs = vb + (t0 + r) * v_st;
        for (int c = c0; c < d; c += 4 * epc) {
          if (scored) cp_async16(sk + r * P.ldk + c, ks + c);
          cp_async16(sv + r * d + c, vs + c);
        }
      }
      cp_async_arrive(&full[s]);
    }
  } else {
    // consumers: q, as float32, while the first tiles are in flight; rows
    // past gn zero
    const T* qb = q + b * q_sb + static_cast<long long>(kvh * G + g0) * q_sh;
    for (int i = tid; i < GMAX * P.nc; i += kConsumers) {
      const int g = i / P.nc, c = (i - g * P.nc) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (g < gn) load8(qb + g * q_sh + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sQ[g * d + c + e] = v[e];
    }
    consumers_sync();

    for (int it = 0; it < ntiles; ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      const T* sk = stage_k(st);
      const T* sv = stage_v(st);
      const int nvalid = min(TILE, end - (start + it * TILE));

      // partial scores of positions lane + 32 k: this warp's eighth of d,
      // every head
      if (scored) {
        float sc[PPL][GMAX];
#pragma unroll
        for (int k = 0; k < PPL; ++k)
#pragma unroll
          for (int g = 0; g < GMAX; ++g) sc[k][g] = 0.f;
#pragma unroll (CHUNK_UNROLL)
        for (int i = 0; i < CPW; ++i) {
          const int c = (warp + kWarps * i) * 8;
          if (c < d) {
            float kf[PPL][8];
#pragma unroll
            for (int k = 0; k < PPL; ++k) load8(sk + (lane + 32 * k) * P.ldk + c, kf[k]);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              float qf[8];
              load8(sQ + g * d + c, qf);
#pragma unroll
              for (int k = 0; k < PPL; ++k) {
                float s0 = 0.f, s1 = 0.f;
#pragma unroll
                for (int e = 0; e < 8; e += 2) {
                  s0 = fmaf(qf[e], kf[k][e], s0);
                  s1 = fmaf(qf[e + 1], kf[k][e + 1], s1);
                }
                sc[k][g] += s0 + s1;
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int k = 0; k < PPL; ++k) sS[(warp * GMAX + g) * TILE + lane + 32 * k] = sc[k][g];
      }
      consumers_sync();                         // the partial scores are in

      if (warp < GMAX) {                        // the online softmax of head `warp`, in log2 units
        float s[PPL], mx = __int_as_float(0xff800000);
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          const int j = lane + 32 * k;
          float dot = 0.f;
          if (scored) {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) dot += sS[(w * GMAX + warp) * TILE + j];
          }
          s[k] = j >= nvalid ? __int_as_float(0xff800000)   // no such row: weight 0
                             : scored ? dot * scale2 : kNegInf;
          mx = fmaxf(mx, s[k]);
        }
        mx = fmaxf(m_run, warp_max(mx));
        float p[PPL], sum = 0.f;
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          p[k] = exp2f(s[k] - mx);
          sum += p[k];
        }
        const float alpha = exp2f(m_run - mx);  // 0 on the first tile (m_run = -inf)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l_run = l_run * alpha + sum;
        m_run = mx;
#pragma unroll
        for (int k = 0; k < PPL; ++k) sP[warp * (TILE + 1) + lane + 32 * k] = p[k];
        if (lane == 0) sAlpha[warp] = alpha;
      }
      consumers_sync();                         // weights and rescale factors are in

      if (active) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float a = sAlpha[g];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= a;
        }
#pragma unroll 2
        for (int j = pset; j < nvalid; j += P.ps) {
          float vf[8];
          load8(sv + j * d + c8, vf);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            const float pj = sP[g * (TILE + 1) + j];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with the stage
    }
  }

  // the split's (m, l, acc) into shared memory: the value phase's position
  // shares first, then their sum in share 0
  __syncthreads();                              // the ring is free
  const int ge = GMAX * d;                      // one share's elements
  if (active) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gn) {
        float* dst = sAcc + pset * ge + g * d + c8;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = acc[g][e];
      }
    }
  }
  if (lane == 0 && warp < gn) {
    sML[warp] = m_run;
    sML[GMAX + warp] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < gn * d; i += kThreads) {
    float a = sAcc[i];
    for (int s = 1; s < P.ps; ++s) a += sAcc[s * ge + i];
    sAcc[i] = a;
  }
  cluster.sync();                               // every split's state is in

  // each head's weight for each split: 2^(m_i - M) / max(L, 1e-30) (m in
  // log2 units, so this is the note's exp(m_i - M));
  // 0 for a split that did no work (l_i = 0)
  if (tid < gn) {
    float m[kMaxSplits], l[kMaxSplits];
    float M = __int_as_float(0xff800000);
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i < ns) {
        const float* ml = cluster.map_shared_rank(sML, i);
        m[i] = ml[tid];
        l[i] = ml[GMAX + tid];
        if (l[i] > 0.f) M = fmaxf(M, m[i]);
      }
    }
    float L = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i < ns) {
        m[i] = l[i] > 0.f ? exp2f(m[i] - M) : 0.f;
        L = fmaf(m[i], l[i], L);
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i)
      if (i < ns) sW[tid * kMaxSplits + i] = m[i] * inv;
  }
  __syncthreads();

  // this block's share of the group's outputs, 4 columns at a time
  const int quads = d / 4;
  T* ob = out + (static_cast<long long>(b) * H + kvh * G + g0) * d;
  for (int e = split * kThreads + tid; e < gn * quads; e += ns * kThreads) {
    const int g = e / quads, c = (e - g * quads) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < ns; ++i) {
      const float w = sW[g * kMaxSplits + i];
      if (w == 0.f) continue;
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sAcc, i) + g * d + c);
      o[0] = fmaf(w, x.x, o[0]);
      o[1] = fmaf(w, x.y, o[1]);
      o[2] = fmaf(w, x.z, o[2]);
      o[3] = fmaf(w, x.w, o[3]);
    }
    store4(ob + g * d + c, o);
  }
  cluster.sync();                               // no block leaves while its state is read
}

constexpr int kMaxDevices = 64;

// An instantiation of the kernel at (G, d): its ring depth, its shared
// memory, and the dynamic shared memory it was allowed on each device.
struct Config {
  const void* kernel;
  int stages, smem;
  int* configured;
};

template <typename T, int GMAX, int DMAX>
Config config_of(int d) {
  static int configured[kMaxDevices] = {};
  const int es = static_cast<int>(sizeof(T));
  const int stages = choose_stages(d, GMAX, es);
  return {reinterpret_cast<const void*>(flash_decode_kernel<T, GMAX, DMAX>), stages,
          make_plan(d, GMAX, es, stages).total, configured};
}

// The instantiation for (G, d): one head or up to 4, d up to 128 or 256.
template <typename T>
Config config(int G, int d) {
  if (group_width(G) == 1) return d <= 128 ? config_of<T, 1, 128>(d) : config_of<T, 1, 256>(d);
  return d <= 128 ? config_of<T, 4, 128>(d) : config_of<T, 4, 256>(d);
}

// The instantiation's dynamic shared memory, allowed once a device and
// size: nothing but the launch on the way of a repeated or captured call.
cudaError_t prepare(const Config& c) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (c.smem > c.configured[dev]) {
    err = cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (err != cudaSuccess) return err;
    c.configured[dev] = c.smem;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cache_len, void* out,
                   int B, int Tc, int H, int KV, int d, int ns, long long q_sb, long long q_sh,
                   long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
                   long long v_sh, float scale, cudaStream_t stream) {
  const Config c = config<T>(H / KV, d);
  cudaError_t err = prepare(c);
  if (err != cudaSuccess) return err;
  int stages = c.stages;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ns) * static_cast<unsigned>(B * KV * head_groups(H / KV)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(c.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];                // the splits of a unit form one cluster
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ns);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the kernel's parameters, in order (a pointer of T is passed as its address)
  void* args[] = {&q, &k, &v, &cache_len, &out, &Tc, &H, &KV, &d, &stages,
                  &q_sb, &q_sh, &k_sb, &k_st, &k_sh, &v_sb, &v_st, &v_sh, &scale};
  return cudaLaunchKernelExC(&cfg, c.kernel, args);
}

bool valid_shape(int dtype, int B, int Tc, int H, int KV, int d) {
  return d >= 8 && d <= 256 && d % 8 == 0 && KV > 0 && H % KV == 0 && B > 0 && Tc > 0 &&
         (dtype == 0 || dtype == 1) &&
         static_cast<long long>(B) * KV * head_groups(H / KV) * kMaxSplits < (1LL << 31);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q [B,H,d] with strides (batch, head) in
// elements and unit last stride; caches [B,T,KV,d] with strides (batch,
// position, head); cache_len int32[B]; out a contiguous [B,H,d] of q's
// type; splits the blocks a (batch, KV head, head group), 1 to 8 (the
// caller's rule is in the note).  One launch.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* k, const void* v,
                                const void* cache_len, void* out, int B, int Tc, int H, int KV,
                                int d, int splits, long long q_sb, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                float scale, void* stream) {
  if (!valid_shape(dtype, B, Tc, H, KV, d) || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(q, k, v, cache_len, out, B, Tc, H, KV, d, splits, q_sb, q_sh, k_sb,
                                 k_st, k_sh, v_sb, v_st, v_sh, scale, s)
                 : launch<__nv_bfloat16>(q, k, v, cache_len, out, B, Tc, H, KV, d, splits, q_sb, q_sh,
                                         k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, s);
  return static_cast<int>(err);
}
