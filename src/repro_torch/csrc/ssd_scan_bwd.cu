// The backward of the Mamba-2 SSD chunk scan (kernel B6, csrc/ssd_scan.cu).
//
// Replaces no TPU kernel: the reference trains the ssm and hybrid families
// by jax.grad of its plain-jnp chunked SSD, src/repro/models/mamba2.py::
// ssd_scan (_chunk_terms), and this computes that gradient on the card:
// from x, dt, B, C, a, dy, d(final state) (optional) and the forward's
// incoming states h_in (ssd_scan_fwd's h_in buffer) to dx, ddt, dB, dC and
// da.  kernels/ssd_scan/ref.py::ssd_bwd_ref is the same decomposition in
// plain PyTorch.  Per chunk, with the forward's notation (acs, L[t, s] =
// exp(acs_t - acs_s) for s <= t, CB = C B^T shared by the heads, xdt = x dt):
//   G_c = sum_t exp(acs_t) dy_t (x) C_t                 the gradient into h_in[c]
//   dS_c = dh[c + 1], dh[nc] = d(final), dh[c] = exp(acs_end) dh[c + 1] + G_c
//   d(xdt)_s = sum_{t>=s} CB[t,s] L[t,s] dy_t + exp(acs_end - acs_s) dS_c B_s
//   dCB[t,s] = sum_h L_h[t,s] (dy_t . xdt_s)_h,   dC = dCB B + sum_h exp(acs) dy h_in,
//   dB = dCB^T C + sum_h exp(acs_end - acs) xdt dS_c
//   d(acs) = row sums - column sums of M = CB o L o (dy . xdt) (the diagonal,
//            which cancels, left out) + exp(acs_t) dy_t . (h_in C_t)
//            - xdt_s . exp(acs_end - acs_s) dS_c B_s, and at the chunk's end
//            the sum of the last term and exp(acs_end) sum(dS_c o h_in[c])
//            (the last position's state term, the largest, cancels there
//            exactly and is left out: summed and subtracted in float32 it
//            cost da ~3e-4 of its size at a = -8, every position's d(la)
//            carrying the rounding)
//   d(la) = the reverse cumulative sum of d(acs) in float64, rounded once;
//   ddt = x . d(xdt) + d(la) a;  da = sum_t d(acs)_t cum_t (cum_t = sum_{u<=t}
//            dt_u = d(acs_t)/da), each term of d(acs) weighted by its own span
//            of dt: a pair's M by cum_t - cum_s, the inter term by cum_t, a
//            state weight by cum_end - cum_s, the decay's by cum_end, summed
//            in float64 (sum d(la) dt would weight every position's rounding
//            by the chunk's cum: ~1e-4 of da at a chunk of 1,024).
// Float32 but for those float64 sums; no float atomics: every sum runs in a
// fixed order, so the same inputs give the same bits on every call.
// The masked pairs are never formed: the decay is expf of one pair's
// difference acs_t - acs_s, only where s <= t (C7).
//
// Bound on the H100: the work is about twice the forward's (per head the
// pair products dy . xdt and (CB o L)^T dy, each half of Q^2 P, and four
// products of Q P N: h_in C, dS B, G and the heads' shares of dC and dB;
// per chunk dCB B and dCB^T C), so it is bound by operations, as the
// forward is (chip_smoke.py::ssd_bwd_work counts them).  The design keeps
// the forward's: the chunks run in parallel and only the reverse carry of
// dh is sequential, in eleven launches on the caller's stream:
//   1.-3. acs, prep, cb (acs and cb: ssd_scan.cuh, the forward's); prep: exp(acs) and
//      dt's cumulative sums from each 64-position tile's start and at the
//      tiles' starts (so that a pair's span is the difference of two small
//      sums plus one of two tile starts);
//   4. chunk_grad: the forward's chunk_state on C, dy and exp(acs) gives G;
//   5. state_pass: one block a (b, h, 32 state rows) walks the chunks in
//      reverse, writing dS_c and its share of sum(dS_c o h_in[c]);
//   6. pairs: one block a (b, chunk, tile pair (t, s), group of 32 heads)
//      forms dy . x per head (a 64 x 64 x P product), its dCB share (summed
//      over the group's heads in registers), each head's row and column sums
//      of M and its sum of M times the pairs' spans; 7. the groups' dCB
//      shares summed in order (H > 32 only);
//   8. dxdt: one block a (b, chunk, h, 64-position tile s), the heavy tiles
//      first: h_in C and dS B (the inter and state terms of d(acs)), then
//      (CB o L)^T dy over the row tiles t >= s, whence dx and ddt's direct
//      term;
//   9. dacs: one warp a (b, chunk, h) sums d(acs) and its reverse cumsum,
//      adds d(la) a to ddt and writes its row's share of da; 10. da sums the
//      shares in order;
//   11. dcdb: one block a (b, chunk, 64-row tile, 64 state columns) and dB
//      or dC: the heads' products (K = H P) and the dCB tiles' product.
// Every product runs on the CUDA cores with the forward's 8 x 8 a thread
// (fma_8x8); the tensor cores are later work, for the forward and the
// backward together.  Layout: as the forward's; dy, dx, ddt, dB and dC
// contiguous ([B, S, H, P], [B, S, H], [B, S, N]), d(final) a contiguous
// [B, H, P, N] or null, h_in a contiguous [B, nc, H, N, P], da [H].
#include "ssd_scan.cuh"

namespace {

constexpr int kPairHeads = 32;       // heads a pairs block walks; more heads take more blocks
constexpr int kBK = 32;              // depth of a stage of the dxdt and dcdb products
constexpr int kRowWarps = 4;         // (b, chunk, h) rows a prep or dacs block
constexpr int kFlat = 256;           // threads of the elementwise launches
constexpr int kMaxTiles = 32;        // 64-position tiles a chunk (Q <= 2,048): prep gives one a lane
constexpr size_t kPairsSmem = sizeof(float) * (3 * kT * kT + kT * (kT + 1) + 5 * kT + 2);

__host__ __device__ int head_groups(int H) { return ceil_div(H, kPairHeads); }
__host__ __device__ int state_blocks(int N) { return ceil_div(N, kPassN); }
long long round4(long long n) { return (n + 3) / 4 * 4; }

// Scratch, in floats, in this order: each row's share of da (doubles); acs,
// dt and w (the forward's acs phase); exp(acs) and dt's cumulative sum from
// each tile's start, each [B][nc][H][qp]; the cb tiles; G_c^T and dS_c^T
// [B][nc][H][N][P]; the head groups' dCB tiles [B][nc][groups][pairs][kT][kT]
// ([s][t], group 0 then holds their sum); the pairs' row and column sums of
// M [B][nc][H][pairs][kT]; the inter and state terms of d(acs) and d(acs)
// itself (then d(la)) [B][nc][H][3][qp]; the pairs' sums of M times their
// spans [B][nc][H][pairs]; dt's sums at the tiles' starts [B][nc][H][32];
// the state blocks' shares of sum(dS o h_in) [B][nc][H][blocks].
struct BwdScratch {
  double* dap;
  float *ad, *ex, *loc, *cb, *g, *ds, *dcb, *rowp, *colp, *im, *dpp, *tstart, *ddec;
};

long long bwd_floats(const Dims& d, BwdScratch* out = nullptr, float* base = nullptr) {
  const long long rows = static_cast<long long>(d.B) * d.nc * d.H;
  const long long sizes[] = {round4(2 * rows), ad_floats(d), rows * d.qp, rows * d.qp, cb_floats(d), st_floats(d),
                             st_floats(d), static_cast<long long>(d.B) * d.nc * head_groups(d.H) * d.pairs * kT * kT,
                             rows * d.pairs * kT, rows * d.pairs * kT, 3 * rows * d.qp, round4(rows * d.pairs),
                             rows * kMaxTiles, round4(rows * state_blocks(d.N))};
  constexpr int kParts = sizeof(sizes) / sizeof(sizes[0]);
  float* parts[kParts];
  long long total = 0;
  for (int i = 0; i < kParts; ++i) {
    parts[i] = base == nullptr ? nullptr : base + total;
    total += sizes[i];
  }
  if (out != nullptr)
    *out = BwdScratch{reinterpret_cast<double*>(parts[0]), parts[1], parts[2], parts[3], parts[4], parts[5], parts[6],
                      parts[7], parts[8], parts[9], parts[10], parts[11], parts[12], parts[13]};
  return total;
}

// As load_transposed, each row r of the block times scale[r].
template <int kDepth, int kThreads>
__device__ __forceinline__ void load_transposed_scaled(float* dst, const float* src, long long stride, int n_rows,
                                                       int width, const float* scale) {
  for (int e = threadIdx.x; e < kT * (kDepth / 4); e += kThreads) {
    const int r = e % kT, k = (e / kT) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && k < width) {
      v = ld4(src + r * stride + k);
      const float s = scale[r];
      v.x *= s; v.y *= s; v.z *= s; v.w *= s;
    }
    dst[(k + 0) * kT + r] = v.x;
    dst[(k + 1) * kT + r] = v.y;
    dst[(k + 2) * kT + r] = v.z;
    dst[(k + 3) * kT + r] = v.w;
  }
}

// For each row of a thread's 8 x 8 block (fma_8x8's layout, columns p0 ..
// p0 + 3 and p0 + 32 .. p0 + 35): the sum over the row's P columns of
// acc[r][.] times src's row (row stride ``stride``), summed over the 8
// threads that hold the row (neighbouring lanes) in a fixed order; 0 for
// rows at or past n_rows.
__device__ __forceinline__ void row_dots(const float (&acc)[8][8], const float* src, long long stride, int n_rows,
                                         int P, int i0, int p0, float (&out)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? r : 28 + r);
    float v = 0.f;
    if (i < n_rows) {
      if (p0 < P) {
        const float4 u = ld4(src + i * stride + p0);
        v = acc[r][0] * u.x + acc[r][1] * u.y + acc[r][2] * u.z + acc[r][3] * u.w;
      }
      if (p0 + 32 < P) {
        const float4 u = ld4(src + i * stride + p0 + 32);
        v += acc[r][4] * u.x + acc[r][5] * u.y + acc[r][6] * u.z + acc[r][7] * u.w;
      }
    }
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    out[r] = v;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// v[0..Q) <- its reverse inclusive cumulative sum (v[u] = sum_{k >= u} v[k])
// in float64, rounded once to float32, by one warp: each lane sums its
// segment, the lanes scan their sums from the top, and each lane walks its
// segment again from its offset.
__device__ void warp_rcumsum(float* v, int Q) {
  const int lane = threadIdx.x & 31;
  const int seg = (Q + 31) / 32;
  const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
  double part = 0.0;
  for (int k = lo; k < hi; ++k) part += static_cast<double>(v[k]);
  double incl = part;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double w = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += w;
  }
  double acc = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) acc = 0.0;
  for (int k = hi - 1; k >= lo; --k) {
    acc += static_cast<double>(v[k]);
    v[k] = static_cast<float>(acc);
  }
}

// The shared phases (ssd_scan.cuh) under the backward's kernel names.
__global__ void __launch_bounds__(32 * kAcsWarps)
ssd_bwd_acs_kernel(const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ ad, Dims d,
                   Strides st) {
  acs_phase(dt, a, ad, d, st);
}

__global__ void __launch_bounds__(kTileThreads)
ssd_bwd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ cb, Dims d,
                  Strides st) {
  cb_phase(bm, cm, cb, d, st);
}

// ---- 4. chunk_grad: G_c^T [N][P] = sum_t C_t (dy_t exp(acs_t)), the forward's chunk_state on C, dy and exp(acs).
__global__ void __launch_bounds__(kStateThreads)
ssd_bwd_chunk_grad_kernel(const float* __restrict__ dy, const float* __restrict__ cm, const float* __restrict__ ex,
                          long long ex_row, float* __restrict__ g, Dims d, Strides st) {
  chunk_state_phase(dy, cm, ex, ex_row, g, d, st);
}

// ---- 2. prep: one warp a (b, chunk, h) row: exp(acs) (0 past the chunk);
// lane T walks tile T: loc[t] = sum of dt from the tile's start to t
// (inclusive, float64 rounded once); tstart[T] = sum of dt before the tile.
__global__ void __launch_bounds__(32 * kRowWarps)
ssd_bwd_prep_kernel(const float* __restrict__ ad, float* __restrict__ ex, float* __restrict__ loc,
                    float* __restrict__ tstart, Dims d) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(d.B) * d.nc * d.H) return;     // the whole warp
  const int lane = threadIdx.x & 31;
  const float* acs = ad + row * 3 * d.qp;
  const float* dts = acs + d.qp;                   // 0 past the chunk
  for (int t = lane; t < d.qp; t += 32) ex[row * d.qp + t] = t < d.Q ? expf(acs[t]) : 0.f;
  double sum = 0.0;
  if (lane < d.nt)
    for (int k = 0; k < kT; ++k) {
      sum += static_cast<double>(dts[lane * kT + k]);
      loc[row * d.qp + lane * kT + k] = static_cast<float>(sum);
    }
  double incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  tstart[row * kMaxTiles + lane] = static_cast<float>(incl - sum);
}

// ---- 5. state_pass: one block a (b, h) and kPassN state rows n, each
// thread a few (n, p): dS_c = dh in reverse chunk order, the block's share
// of sum(dS_c o h_in[c]) (each thread's cells, then the warps, then the
// block, in order), dh <- exp(acs_end) dh + G_c.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass_kernel(const float* __restrict__ ad, const float* __restrict__ g, const float* __restrict__ hins,
                          const float* __restrict__ dfin, float* __restrict__ ds, float* __restrict__ ddec, Dims d) {
  constexpr int kPer = kPassN * kT / kPassThreads;
  __shared__ float warp_part[kPassThreads / 32];
  const int blocks = state_blocks(d.N);
  const long long bh = blockIdx.x / blocks;
  const int blk = static_cast<int>(blockIdx.x - bh * blocks);
  const int n_base = blk * kPassN, n_rows = min(kPassN, d.N - n_base);
  const int hh = static_cast<int>(bh % d.H), b = static_cast<int>(bh / d.H);
  const long long np = static_cast<long long>(d.N) * d.P;
  const int cells = n_rows * d.P, tid = threadIdx.x;
  auto at = [&](int c) { return ((static_cast<long long>(b) * d.nc + c) * d.H + hh) * np + n_base * d.P; };
  float dh[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int f = tid + u * kPassThreads;
    dh[u] = 0.f;
    if (dfin != nullptr && f < cells) {
      const int n = f / d.P, p = f - n * d.P;
      dh[u] = dfin[(bh * d.P + p) * d.N + n_base + n];       // d(final) is [B, H, P, N]
    }
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    const long long row = (static_cast<long long>(b) * d.nc + c) * d.H + hh;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int f = tid + u * kPassThreads;
      if (f < cells) {
        ds[at(c) + f] = dh[u];
        part = fmaf(dh[u], hins[at(c) + f], part);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) warp_part[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < kPassThreads / 32; ++w) sum += warp_part[w];
      ddec[row * blocks + blk] = sum;
    }
    __syncthreads();                               // warp_part is read before the next chunk writes it
    if (c == 0) break;
    const float decay = expf(ad[row * 3 * d.qp + d.Q - 1]);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int f = tid + u * kPassThreads;
      if (f < cells) dh[u] = fmaf(decay, dh[u], g[at(c) + f]);
    }
  }
}

// ---- 6. pairs: one block a (b, chunk, tile pair (t, s), s <= t, group of
// kPairHeads heads).  Per head: acc[s][t] = x_s . dy_t (P deep), then
// L dt_s acc into the group's dCB tile (registers) and M = CB o L dt_s acc
// (the diagonal left out) into shared memory, whose row sums (over s, for
// each t) and column sums (over t, for each s) go to rowp and colp.
__global__ void __launch_bounds__(kTileThreads)
ssd_bwd_pairs_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ ad,
                     const float* __restrict__ loc, const float* __restrict__ tstart, const float* __restrict__ cb,
                     float* __restrict__ dcb, float* __restrict__ rowp, float* __restrict__ colp,
                     float* __restrict__ dpp, Dims d, Strides st) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);     // [p][s]: x of the column tile, transposed
  float* sD = sX + kT * kT;                        // [p][t]: dy of the row tile, transposed
  float* sCB = sD + kT * kT;                       // [s][t]: the C B^T tile as the cb phase stores it
  float* sM = sCB + kT * kT;                       // [s][t], row stride kT + 1: M
  float* sAt = sM + kT * (kT + 1);                 // acs of the rows t
  float* sAs = sAt + kT;                           // acs of the columns s
  float* sDs = sAs + kT;                           // dt of the columns s
  float* sLt = sDs + kT;                           // dt summed from the row tile's start to t
  float* sLs = sLt + kT;                           // and from the column tile's start to s
  float* sRed = sLs + kT;                          // the two warps' sums of M times the spans
  const int groups = head_groups(d.H);
  long long blk = blockIdx.x;                      // group fastest, then pair, then (b, chunk)
  const int grp = static_cast<int>(blk % groups);
  blk /= groups;
  const int pair = static_cast<int>(blk % d.pairs);
  const long long bc = blk / d.pairs;
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  int t = static_cast<int>((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= pair) ++t;
  while (t * (t + 1) / 2 > pair) --t;
  const int s = pair - t * (t + 1) / 2;
  const int t0 = t * kT, s0 = s * kT;
  const int t_rows = min(kT, d.Q - t0), s_rows = min(kT, d.Q - s0);
  const int tid = threadIdx.x, i0 = (tid / 8) * 4, j0 = (tid % 8) * 4;
  const float* tile = cb + (bc * d.pairs + pair) * kT * kT;
  for (int e = tid; e < kT * kT / 4; e += kTileThreads) st4(sCB + 4 * e, ld4(tile + 4 * e));
  const long long dy_s = static_cast<long long>(d.H) * d.P;
  const float* xr = x + b * st.x_b + (static_cast<long long>(c) * d.Q + s0) * st.x_s;
  const float* dyr = dy + (static_cast<long long>(b) * d.S + static_cast<long long>(c) * d.Q + t0) * dy_s;
  float acc_dcb[8][8] = {};
  const int h_end = min(d.H, (grp + 1) * kPairHeads);
  for (int hh = grp * kPairHeads; hh < h_end; ++hh) {
    const long long row = bc * d.H + hh;
    const float* acs = ad + row * 3 * d.qp;
    // a pair's span cum_t - cum_s: the tile starts' difference (0 on the diagonal) + sLt[t] - sLs[s]
    const float span0 = tstart[row * kMaxTiles + t] - tstart[row * kMaxTiles + s];
    __syncthreads();                               // the previous head's readers are done
    load_transposed<kT, kTileThreads>(sX, xr + hh * st.x_h, st.x_s, s_rows, d.P);
    load_transposed<kT, kTileThreads>(sD, dyr + hh * d.P, dy_s, t_rows, d.P);
    sAt[tid] = acs[t0 + tid];                      // one each (kTileThreads == kT); 0 past the chunk
    sAs[tid] = acs[s0 + tid];
    sDs[tid] = acs[d.qp + s0 + tid];
    sLt[tid] = loc[row * d.qp + t0 + tid];
    sLs[tid] = loc[row * d.qp + s0 + tid];
    __syncthreads();
    float acc[8][8] = {};
    fma_8x8<kT, kT, 32, false>(acc, sX, sD, nullptr, i0, j0, d.P);
    float spanned = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int si = i0 + (r < 4 ? r : 28 + r);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int tj = j0 + (q < 4 ? q : 28 + q);
        const bool live = s0 + si <= t0 + tj && tj < t_rows;
        const float ld = live ? expf(sAt[tj] - sAs[si]) * sDs[si] * acc[r][q] : 0.f;
        acc_dcb[r][q] += ld;
        const float m = live && s0 + si < t0 + tj ? sCB[si * kT + tj] * ld : 0.f;
        sM[si * (kT + 1) + tj] = m;
        spanned = fmaf(m, span0 + (sLt[tj] - sLs[si]), spanned);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) spanned += __shfl_xor_sync(0xffffffffu, spanned, off);
    if ((tid & 31) == 0) sRed[tid >> 5] = spanned;
    __syncthreads();
    float rs = 0.f, cs = 0.f;
    for (int k = 0; k < kT; ++k) {
      rs += sM[k * (kT + 1) + tid];
      cs += sM[tid * (kT + 1) + k];
    }
    const long long part = (row * d.pairs + pair) * kT;
    rowp[part + tid] = rs;
    colp[part + tid] = cs;
    if (tid == 0) dpp[row * d.pairs + pair] = sRed[0] + sRed[1];
  }
  float* out = dcb + ((bc * groups + grp) * d.pairs + pair) * kT * kT;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int si = i0 + (r < 4 ? r : 28 + r);
    st4(out + si * kT + j0, quad(acc_dcb, r, 0));
    st4(out + si * kT + j0 + 32, quad(acc_dcb, r, 1));
  }
}

// ---- 7. the head groups' dCB tiles summed in order into group 0's.
__global__ void __launch_bounds__(kFlat)
ssd_bwd_dcb_sum_kernel(float* __restrict__ dcb, Dims d) {
  const int groups = head_groups(d.H);
  const long long per = static_cast<long long>(d.pairs) * kT * kT / 4;     // float4 of a (b, chunk, group)
  const long long i = static_cast<long long>(blockIdx.x) * kFlat + threadIdx.x;
  if (i >= static_cast<long long>(d.B) * d.nc * per) return;
  const long long bc = i / per;
  float4* base = reinterpret_cast<float4*>(dcb) + bc * groups * per + (i - bc * per);
  float4 acc = base[0];
  for (int g = 1; g < groups; ++g) {
    const float4 v = base[g * per];
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  base[0] = acc;
}

// acc[i][p] += sum_n R_i[n] M[n][p] over the state's N rows, R the tile's
// rows of C or B (row stride r_s), M = h_in[c] or dS_c ([N][P]), in stages
// of kBK state rows through sA ([n][i]) and sB ([n][p]).
__device__ __forceinline__ void state_product(float (&acc)[8][8], float* sA, float* sB, const float* rr,
                                              long long r_s, const float* m, int rows, const Dims& d, int i0,
                                              int p0) {
  for (int n0 = 0; n0 < d.N; n0 += kBK) {
    const int kn = min(kBK, d.N - n0);
    __syncthreads();                               // the previous stage's readers are done
    load_transposed<kBK, kTileThreads>(sA, rr + n0, r_s, rows, kn);
    async_rows<kBK, kT, kTileThreads>(sB, m + static_cast<long long>(n0) * d.P, d.P, kn, d.P);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    fma_8x8<kT, kT, 32, false>(acc, sA, sB, nullptr, i0, p0, kn);
  }
}

// ---- 8. dxdt: one block a (b, chunk, h, 64-position tile s); acc[s][p].
__global__ void __launch_bounds__(kTileThreads, 1)
ssd_bwd_dxdt_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ ad, const float* __restrict__ ex,
                    const float* __restrict__ cb, const float* __restrict__ hins, const float* __restrict__ dss,
                    float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ im, Dims d, Strides st) {
  __shared__ __align__(16) float sA[kBK * kT];     // [k][s]: the left operand, k-major
  __shared__ __align__(16) float sB[kBK * kT];     // [k][p]: the right operand
  __shared__ float sAs[kT];                        // acs of the tile's positions
  __shared__ float sAt[kBK];                       // acs of a stage's positions t
  long long blk = blockIdx.x;                      // head fastest, then (b, chunk), heavy tiles (s low) first
  const int hh = static_cast<int>(blk % d.H);
  blk /= d.H;
  const long long n_bc = static_cast<long long>(d.B) * d.nc;
  const long long bc = blk % n_bc;
  const int stile = static_cast<int>(blk / n_bc);
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  const int s0 = stile * kT, rows = min(kT, d.Q - s0);
  const long long row = bc * d.H + hh;
  const float* acs = ad + row * 3 * d.qp;
  const float* dts = acs + d.qp;
  const long long dy_s = static_cast<long long>(d.H) * d.P;
  const long long pos0 = static_cast<long long>(c) * d.Q + s0;    // the tile's first position
  const float* xr = x + b * st.x_b + pos0 * st.x_s + hh * st.x_h;
  const float* dyc = dy + (static_cast<long long>(b) * d.S + static_cast<long long>(c) * d.Q) * dy_s + hh * d.P;
  const float* br = bm + b * st.b_b + pos0 * st.b_s;
  const float* cr = cm + b * st.c_b + pos0 * st.c_s;
  const int tid = threadIdx.x, i0 = (tid / 8) * 4, p0 = (tid % 8) * 4;
  sAs[tid] = acs[s0 + tid];
  float* irow = im + row * 3 * d.qp;               // the inter terms, then the state terms, of d(acs)

  float acc[8][8] = {};
  float dots[8];
  // the inter term exp(acs_s) dy_s . (h_in[c] C_s) (h_in[0] = 0)
  if (c > 0) state_product(acc, sA, sB, cr, st.c_s, hins + row * d.N * d.P, rows, d, i0, p0);
  row_dots(acc, dyc + static_cast<long long>(s0) * dy_s, dy_s, rows, d.P, i0, p0, dots);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? r : 28 + r);
    if ((tid & 7) == 0 && i < rows) irow[s0 + i] = ex[row * d.qp + s0 + i] * dots[r];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  }
  // the state's rows exp(acs_end - acs_s) dS_c B_s, and their term xdt_s . (...) of d(acs)
  state_product(acc, sA, sB, br, st.b_s, dss + row * d.N * d.P, rows, d, i0, p0);
  const float a_end = acs[d.Q - 1];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? r : 28 + r);
    const float w = i < rows ? expf(a_end - sAs[i]) : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] *= w;
  }
  row_dots(acc, xr, st.x_s, rows, d.P, i0, p0, dots);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? r : 28 + r);
    if ((tid & 7) == 0 && i < rows) irow[d.qp + s0 + i] = dts[s0 + i] * dots[r];
  }
  // the pairs: acc[s][p] += sum_{t >= s} CB[t][s] exp(acs_t - acs_s) dy_t[p]; thread tid scales column s0 + tid
  const float a_s = sAs[tid];
  for (int tt = stile; tt < d.nt; ++tt) {
    const float* tile = cb + (bc * d.pairs + tt * (tt + 1) / 2 + stile) * kT * kT;    // [s][t]
    for (int jb = 0; jb < kT && tt * kT + jb < d.Q; jb += kBK) {
      const int t_base = tt * kT + jb;
      __syncthreads();
      load_transposed<kBK, kTileThreads>(sA, tile + jb, kT, kT, kBK);               // sA[k][s] = CB[t_base + k][s]
      async_rows<kBK, kT, kTileThreads>(sB, dyc + static_cast<long long>(t_base) * dy_s, dy_s, d.Q - t_base, d.P);
      cp_async_commit();
      if (tid < kBK) sAt[tid] = acs[t_base + tid];
      cp_async_wait_all();
      __syncthreads();
      for (int k = 0; k < kBK; ++k) {
        const bool live = s0 + tid <= t_base + k && t_base + k < d.Q;
        sA[k * kT + tid] = live ? sA[k * kT + tid] * expf(sAt[k] - a_s) : 0.f;
      }
      __syncthreads();
      fma_8x8<kT, kT, 32, false>(acc, sA, sB, nullptr, i0, p0, kBK);
    }
  }
  // dx = d(xdt) dt, ddt's direct term x . d(xdt)
  row_dots(acc, xr, st.x_s, rows, d.P, i0, p0, dots);
  float* dxr = dx + ((static_cast<long long>(b) * d.S + pos0) * d.H + hh) * d.P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? r : 28 + r);
    if (i >= rows) continue;
    const float dtv = dts[s0 + i];
    if (p0 < d.P)
      st4(dxr + i * dy_s + p0, make_float4(acc[r][0] * dtv, acc[r][1] * dtv, acc[r][2] * dtv, acc[r][3] * dtv));
    if (p0 + 32 < d.P)
      st4(dxr + i * dy_s + p0 + 32,
          make_float4(acc[r][4] * dtv, acc[r][5] * dtv, acc[r][6] * dtv, acc[r][7] * dtv));
    if ((tid & 7) == 0) ddt[(static_cast<long long>(b) * d.S + pos0 + i) * d.H + hh] = dots[r];
  }
}

// ---- 9. dacs: one warp a (b, chunk, h) row, lane l a segment of the
// chunk's positions: d(acs) = the pairs' row sums - column sums + the inter
// term - the state term (the last position's left out) and, at the chunk's
// end, the state terms' sum and the decay's; its reverse cumsum d(la);
// ddt += d(la) a; the row's share of da = the pairs' spanned sums + sum_t
// inter_t cum_t + sum_{s < end} state_s (cum_end - cum_s) + the decay's
// term cum_end, in float64.
__global__ void __launch_bounds__(32 * kRowWarps)
ssd_bwd_dacs_kernel(const float* __restrict__ ad, const float* __restrict__ rowp, const float* __restrict__ colp,
                   float* __restrict__ im, const float* __restrict__ dpp, const float* __restrict__ ddec,
                   const float* __restrict__ a, float* __restrict__ ddt, double* __restrict__ dap, Dims d,
                   Strides st) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(d.B) * d.nc * d.H) return;     // the whole warp
  const int hh = static_cast<int>(row % d.H);
  const long long bc = row / d.H;
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  const int lane = threadIdx.x & 31;
  const float* acs = ad + row * 3 * d.qp;
  const float* dts = acs + d.qp;
  const float* inter = im + row * 3 * d.qp;
  const float* sterm = inter + d.qp;
  float* dacs = im + row * 3 * d.qp + 2 * d.qp;    // d(acs), then d(la)
  const float* rp = rowp + row * d.pairs * kT;
  const float* cp = colp + row * d.pairs * kT;
  const int seg = (d.Q + 31) / 32;
  const int lo = min(d.Q, lane * seg), hi = min(d.Q, lo + seg);
  double ssum = 0.0, dtsum = 0.0;
  for (int u = lo; u < hi; ++u) {
    const int tu = u / kT, uu = u - tu * kT;
    float r_sum = 0.f, c_sum = 0.f;
    for (int k = 0; k <= tu; ++k) r_sum += rp[(tu * (tu + 1) / 2 + k) * kT + uu];
    for (int k = tu; k < d.nt; ++k) c_sum += cp[(k * (k + 1) / 2 + tu) * kT + uu];
    float v = r_sum - c_sum + inter[u];
    if (u < d.Q - 1) {                             // the last position's state term cancels exactly
      v -= sterm[u];
      ssum += static_cast<double>(sterm[u]);
    }
    dacs[u] = v;
    dtsum += static_cast<double>(dts[u]);
  }
  ssum = warp_sum(ssum);
  const int blocks = state_blocks(d.N);
  float dec = 0.f;
  for (int k = 0; k < blocks; ++k) dec += ddec[row * blocks + k];
  const double dec_term = static_cast<double>(expf(acs[d.Q - 1]) * dec);
  // cum before the segment, and the chunk's total
  double incl = dtsum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const double total = __shfl_sync(0xffffffffu, incl, 31);
  double cum = incl - dtsum, part = 0.0;
  for (int u = lo; u < hi; ++u) {
    cum += static_cast<double>(dts[u]);
    part += static_cast<double>(inter[u]) * cum;
    if (u < d.Q - 1) part += static_cast<double>(sterm[u]) * (total - cum);
  }
  part = warp_sum(part);
  __syncwarp();
  if (lane == 0) dacs[d.Q - 1] += static_cast<float>(ssum + dec_term);
  __syncwarp();
  warp_rcumsum(dacs, d.Q);
  __syncwarp();
  const float a_h = a[hh * st.a_h];
  for (int u = lane; u < d.Q; u += 32) {
    float* o = ddt + ((static_cast<long long>(b) * d.S + static_cast<long long>(c) * d.Q + u) * d.H + hh);
    *o = __fadd_rn(*o, __fmul_rn(dacs[u], a_h));
  }
  if (lane == 0) {
    double pairs = 0.0;
    for (int k = 0; k < d.pairs; ++k) pairs += static_cast<double>(dpp[row * d.pairs + k]);
    dap[row] = part + pairs + total * dec_term;
  }
}

// ---- 10. da[h] = the rows' shares summed in (b, chunk) order.
__global__ void __launch_bounds__(kFlat)
ssd_bwd_da_kernel(const double* __restrict__ dap, float* __restrict__ da, Dims d) {
  const int hh = blockIdx.x * kFlat + threadIdx.x;
  if (hh >= d.H) return;
  double sum = 0.0;
  for (long long bc = 0; bc < static_cast<long long>(d.B) * d.nc; ++bc) sum += dap[bc * d.H + hh];
  da[hh] = static_cast<float>(sum);
}

// ---- 11. dcdb: one block a (b, chunk, 64-row tile r, 64 state columns),
// blockIdx.y 0 for dC, 1 for dB; acc[i][n].
//   dC_t = sum_h exp(acs_t) dy_t . h_in[c] + sum_{s <= t} dCB[t][s] B_s
//   dB_s = sum_h w_s x_s . dS_c + sum_{t >= s} dCB[t][s] C_t,  w = dt exp(acs_end - acs)
__global__ void __launch_bounds__(kTileThreads)
ssd_bwd_dcdb_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ ad, const float* __restrict__ ex,
                    const float* __restrict__ dcb, const float* __restrict__ hins, const float* __restrict__ dss,
                    float* __restrict__ db, float* __restrict__ dc, Dims d, Strides st) {
  __shared__ __align__(16) float sA[kBK * kT];     // [k][i]: the left operand, k-major
  __shared__ __align__(16) float sB[kBK * kT];     // [k][n]
  const bool is_db = blockIdx.y == 1;
  const int n_tiles = ceil_div(d.N, kT);
  long long blk = blockIdx.x;                      // state columns fastest, then row tile, then (b, chunk)
  const int nt_i = static_cast<int>(blk % n_tiles);
  blk /= n_tiles;
  const int r = static_cast<int>(blk % d.nt);
  const long long bc = blk / d.nt;
  const int c = static_cast<int>(bc % d.nc), b = static_cast<int>(bc / d.nc);
  const int r0 = r * kT, rows = min(kT, d.Q - r0);
  const int nb = nt_i * kT, ncols = min(kT, d.N - nb);
  const long long pos0 = static_cast<long long>(c) * d.Q + r0;
  const long long dy_s = static_cast<long long>(d.H) * d.P;
  const int tid = threadIdx.x, i0 = (tid / 8) * 4, n0 = (tid % 8) * 4;
  float acc[8][8] = {};
  if (is_db || c > 0) {                            // h_in[0] = 0: chunk 0's dC has no heads' term
    for (int hh = 0; hh < d.H; ++hh) {
      const long long row = bc * d.H + hh;
      const float* scale = is_db ? ad + row * 3 * d.qp + 2 * d.qp + r0 : ex + row * d.qp + r0;
      const float* src = is_db ? x + b * st.x_b + pos0 * st.x_s + hh * st.x_h
                               : dy + (static_cast<long long>(b) * d.S + pos0) * dy_s + hh * d.P;
      const long long src_s = is_db ? st.x_s : dy_s;
      const float* m = (is_db ? dss : hins) + row * d.N * d.P + static_cast<long long>(nb) * d.P;   // rows n of [N][P]
      for (int pc = 0; pc < d.P; pc += kBK) {
        const int kn = min(kBK, d.P - pc);
        __syncthreads();
        load_transposed_scaled<kBK, kTileThreads>(sA, src + pc, src_s, rows, kn, scale);   // [p][i] scale_i
        load_transposed<kBK, kTileThreads>(sB, m + pc, d.P, ncols, kn);                     // [p][n]
        __syncthreads();
        fma_8x8<kT, kT, 32, false>(acc, sA, sB, nullptr, i0, n0, kn);
      }
    }
  }
  const float* tiles = dcb + bc * head_groups(d.H) * d.pairs * kT * kT;     // group 0 holds the sum
  const float* other = is_db ? cm + b * st.c_b : bm + b * st.b_b;
  const long long o_s = is_db ? st.c_s : st.b_s;
  for (int k = is_db ? r : 0; k < (is_db ? d.nt : r + 1); ++k) {
    // dC (rows t of tile r): tile (r, k) is [s][t], k-major as it lies; dB (rows s of tile r): tile (k, r), transposed
    const float* tile = tiles + static_cast<long long>(is_db ? k * (k + 1) / 2 + r : r * (r + 1) / 2 + k) * kT * kT;
    const float* orow = other + (static_cast<long long>(c) * d.Q + k * kT) * o_s + nb;
    for (int jb = 0; jb < kT && k * kT + jb < d.Q; jb += kBK) {
      __syncthreads();
      if (is_db)
        load_transposed<kBK, kTileThreads>(sA, tile + jb, kT, kT, kBK);
      else
        async_rows<kBK, kT, kTileThreads>(sA, tile + jb * kT, kT, kBK, kT);
      async_rows<kBK, kT, kTileThreads>(sB, orow + jb * o_s, o_s, d.Q - (k * kT + jb), ncols);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      fma_8x8<kT, kT, 32, false>(acc, sA, sB, nullptr, i0, n0, kBK);
    }
  }
  float* out = (is_db ? db : dc) + (static_cast<long long>(b) * d.S + pos0) * d.N + nb;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = i0 + (q < 4 ? q : 28 + q);
    if (i >= rows) continue;
    if (n0 < ncols) st4(out + i * d.N + n0, quad(acc, q, 0));
    if (n0 + 32 < ncols) st4(out + i * d.N + n0 + 32, quad(acc, q, 1));
  }
}

bool valid_bwd(int B, int S, int H, int P, int N, int Q) {
  if (!valid(B, S, H, P, N, Q)) return false;
  const Dims d = dims(B, S, H, P, N, Q);
  if (d.nt > kMaxTiles) return false;
  const long long bcs = static_cast<long long>(B) * d.nc;
  return bcs * d.pairs * head_groups(H) < (1LL << 31) && bcs * d.nt * ceil_div(N, kT) < (1LL << 31) &&
         bcs * H < (1LL << 31);
}

}  // namespace

// Floats of scratch the backward needs at these sizes; -1 for a shape it
// does not take (the forward's).
extern "C" long long ssd_scan_bwd_scratch_floats(int B, int S, int H, int P, int N, int Q) {
  if (!valid_bwd(B, S, H, P, N, Q)) return -1;
  return bwd_floats(dims(B, S, H, P, N, Q));
}

// The largest dynamic shared memory of the backward's launches, in bytes.
extern "C" long long ssd_scan_bwd_smem_bytes() {
  return static_cast<long long>(kPairsSmem > kStateSmem ? kPairsSmem : kStateSmem);
}

// x, dt, bm (B), cm (C), a: the forward's inputs, read through the strides
// below as ssd_scan_fwd reads them; dy a contiguous [B, S, H, P]; dh_final
// a contiguous [B, H, P, N] or null (zero); h_in the forward's contiguous
// [B, nc, H, N, P]; dx, ddt, db, dc, da contiguous outputs ([B, S, H, P],
// [B, S, H], [B, S, N] twice, [H]); scratch a 16-byte aligned float32
// buffer of ssd_scan_bwd_scratch_floats.  Eleven launches (ten where H <=
// 32) on ``stream``; returns the first CUDA error (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* bm, const void* cm, const void* a,
                            const void* dy, const void* dh_final, const void* h_in, void* dx, void* ddt, void* db,
                            void* dc, void* da, void* scratch, int B, int S, int H, int P, int N, int Q,
                            long long x_b, long long x_s, long long x_h, long long dt_b, long long dt_s,
                            long long dt_h, long long b_b, long long b_s, long long c_b, long long c_s,
                            long long a_h, void* stream) {
  if (!valid_bwd(B, S, H, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, a_h};
  const Dims d = dims(B, S, H, P, N, Q);
  BwdScratch sc;
  bwd_floats(d, &sc, static_cast<float*>(scratch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* dyf = static_cast<const float*>(dy);
  const auto* hin = static_cast<const float*>(h_in);
  const long long rows = static_cast<long long>(B) * d.nc * H;
  const long long bcs = static_cast<long long>(B) * d.nc;
  const int groups = head_groups(H);
  auto flat_grid = [](long long n) { return static_cast<unsigned>((n + kFlat - 1) / kFlat); };
  const auto row_grid = static_cast<unsigned>((rows + kRowWarps - 1) / kRowWarps);
  cudaError_t err;

  ssd_bwd_acs_kernel<<<static_cast<unsigned>(ceil_div(static_cast<int>(rows), kAcsWarps)), 32 * kAcsWarps, 0,
                       s>>>(static_cast<const float*>(dt), static_cast<const float*>(a), sc.ad, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_prep_kernel<<<row_grid, 32 * kRowWarps, 0, s>>>(sc.ad, sc.ex, sc.loc, sc.tstart, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_cb_kernel<<<static_cast<unsigned>(bcs * d.pairs), kTileThreads, 0, s>>>(bf, cf, sc.cb, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // G^T: the chunk_state phase on C and dy (read through x's and B's strides) and exp(acs)
  Strides gst = st;
  gst.x_b = static_cast<long long>(S) * H * P;
  gst.x_s = static_cast<long long>(H) * P;
  gst.x_h = P;
  gst.b_b = c_b;
  gst.b_s = c_s;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kStateSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_grad_kernel<<<dim3(static_cast<unsigned>(rows), ceil_div(N, kStateRows)), kStateThreads,
                              kStateSmem, s>>>(dyf, cf, sc.ex, d.qp, sc.g, d, gst);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_state_pass_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * H * state_blocks(N)), kPassThreads,
                              0, s>>>(sc.ad, sc.g, hin, static_cast<const float*>(dh_final), sc.ds, sc.ddec, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(ssd_bwd_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kPairsSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pairs_kernel<<<static_cast<unsigned>(bcs * d.pairs * groups), kTileThreads, kPairsSmem, s>>>(
      xf, dyf, sc.ad, sc.loc, sc.tstart, sc.cb, sc.dcb, sc.rowp, sc.colp, sc.dpp, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if (groups > 1) {
    ssd_bwd_dcb_sum_kernel<<<flat_grid(bcs * d.pairs * kT * kT / 4), kFlat, 0, s>>>(sc.dcb, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }

  ssd_bwd_dxdt_kernel<<<static_cast<unsigned>(rows * d.nt), kTileThreads, 0, s>>>(
      xf, dyf, bf, cf, sc.ad, sc.ex, sc.cb, hin, sc.ds, static_cast<float*>(dx), static_cast<float*>(ddt), sc.im,
      d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_dacs_kernel<<<row_grid, 32 * kRowWarps, 0, s>>>(sc.ad, sc.rowp, sc.colp, sc.im, sc.dpp, sc.ddec,
                                                        static_cast<const float*>(a), static_cast<float*>(ddt),
                                                        sc.dap, d, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_da_kernel<<<flat_grid(H), kFlat, 0, s>>>(sc.dap, static_cast<float*>(da), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_dcdb_kernel<<<dim3(static_cast<unsigned>(bcs * d.nt * ceil_div(N, kT)), 2), kTileThreads, 0, s>>>(
      xf, dyf, bf, cf, sc.ad, sc.ex, sc.dcb, hin, sc.ds, static_cast<float*>(db), static_cast<float*>(dc), d, st);
  return static_cast<int>(cudaGetLastError());
}
