// Pairwise IoU matrix and the fused match-and-update of the ExSample
// detection matcher.
//
// Replaces the TPU kernel src/repro/kernels/iou_match/kernel.py::iou_matrix
// (body _iou_kernel): out[d, r] = IoU of box a[d] and box b[r], boxes as
// (x0, y0, x1, y1), widths and heights clamped at 0,
//     union = area_a + area_b - inter,   out = inter / max(union, 1e-9).
// The TPU kernel's own note says why it exists: fused on the device, the
// matcher's IoU disappears into the detector's batch.  Here it is fused:
// match_update_kernel does the whole IoU-only matcher step of
// src/repro/core/matcher.py::match_and_update in one launch.
//
// iou_of is the one IoU of both kernels.  It follows the reference
// operation for operation with explicitly rounded intrinsics, except at
// the one site where the jitted reference's CPU backend fuses a multiply
// into the add (area_b's product into area_a + area_b): there it uses
// fmaf, and the plain version an exact float32 FMA, so kernel, plain
// version and jitted reference agree bit for bit.
//
// iou_matrix_kernel: a 2-D grid of (32 R-columns x 8 D-rows) tiles, one
// output per thread, each box read as one float4; neighbouring threads
// write neighbouring columns, so stores coalesce.  At the matcher's D=16
// detections and R=8192 ring slots a launch reads 131 KB and writes 524 KB
// (0.2 us at 3.35 TB/s): it is bound by launch latency, and the matcher
// around it was ~70 more launches a frame.  The batched entry runs Q
// independent matrices in one launch (blockIdx.z is the query).  Since the
// fusion below, only the matcher's cosine path (feat_thresh > -1) calls it.
//
// match_update_kernel: one frame's D detections against one ring of R
// slots, Q (frame, ring) pairs a launch, into fresh output tensors.
//   * A pair (d, r) is eligible iff times_seen[r] > 0, video[r] == video_id,
//     |frame[r] - frame_id| <= time_gate (in 64 bits) and IoU >= iou_thresh
//     (the threshold as float32).  best[d] is the first slot of the largest
//     eligible IoU (argmax's rule); a valid detection with an eligible slot
//     bumps it, a valid detection without one is new.
//   * new_seen = times_seen + bumps on occupied slots; went_twice =
//     occupied & times_seen == 1 & new_seen >= 2; crossed = went_twice &
//     chunk != chunk_id; d1, cross_chunk their counts; cross_home = chunk
//     where crossed, else -1; d0 the count of new detections.
//   * New detection d, the k-th new one, takes slot (cursor + k) % R: box,
//     feats, video_id, frame_id and chunk_id as int32, times_seen = 1,
//     written after the bumps (an insert overwrites a slot bumped in the
//     same frame).  Where more than R are new, the last one of a slot wins,
//     as a scatter applied in order does.  cursor += d0 (mod R),
//     total_inserted += d0.
// Design: each query is one thread-block cluster of kBlocks = 8 blocks (the
// portable maximum), block i owning slots [i*p, min((i+1)*p, R)), p =
// ceil(R / 8); a block may own none (R < 8).  Phase A: each of 1,024 threads
// takes one slot at a time (one pass at R = 8192), gates it once, and for
// every detection reduces (IoU, slot) to the first maximum across its warp
// by shuffles, skipped where no pair of the warp is eligible (nearly all:
// a detection matches one entry or none), then across the block's warps
// through shared memory.  After a cluster barrier every block
// reads all eight partial maxima through distributed shared memory and
// derives best, has_match, is_new and the insert order of all D detections
// itself, so no second exchange is needed for them.  Phase B: each thread
// counts its slots' bumps with a loop over D and writes each slot once,
// either the carried-over row or the inserted one.  The counts d1 and
// cross_chunk meet in rank 0's shared memory by cluster atomics behind a
// second barrier; rank 0 writes the per-query scalars and is_new.
//
// Bound on the H100: bytes.  Per slot the kernel reads the ring's box,
// features, video, frame, chunk and times_seen (32 + 4F bytes) and writes
// them and cross_home (36 + 4F); at R = 8192 and F = 8 that is 1.08 MB,
// 0.32 us at 3.35 TB/s; at (Q, D, R) = (8, 16, 8192) 8.65 MB, 2.6 us.  Its
// ~25*D*R operations are far below that.  At the main path's shape a
// launch's fixed cost (the cluster launch and two cluster barriers)
// dominates; the gain is the ~70 launches a frame it replaces.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileR = 32;
constexpr int kTileD = 8;

constexpr int kBlocks = 8;                 // blocks a query: one portable cluster
constexpr int kThreads = 1024;               // one pass over a block's slots at R = 8192
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 64;                  // detections a frame
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float iou_of(const float4 A, const float4 B) {
  const float aw = fmaxf(__fsub_rn(A.z, A.x), 0.0f);
  const float ah = fmaxf(__fsub_rn(A.w, A.y), 0.0f);
  const float bw = fmaxf(__fsub_rn(B.z, B.x), 0.0f);
  const float bh = fmaxf(__fsub_rn(B.w, B.y), 0.0f);
  const float area_a = __fmul_rn(aw, ah);
  const float iw = fmaxf(__fsub_rn(fminf(A.z, B.z), fmaxf(A.x, B.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(A.w, B.w), fmaxf(A.y, B.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(fmaf(bw, bh, area_a), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void __launch_bounds__(kTileR * kTileD)
iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b, int d, int r,
                  float* __restrict__ out) {
  const int j = blockIdx.x * kTileR + threadIdx.x;
  const int i = blockIdx.y * kTileD + threadIdx.y;
  if (i >= d || j >= r) return;
  a += static_cast<size_t>(blockIdx.z) * d;   // this query's matrices
  b += static_cast<size_t>(blockIdx.z) * r;
  out += static_cast<size_t>(blockIdx.z) * d * r;
  out[static_cast<size_t>(i) * r + j] = iou_of(a[i], b[j]);
}

// One launch's operands.  Detection inputs and the ids are read at
// q * (their query stride, in elements); an id is int32 or int64 (id_bytes
// 4 or 8) with stride 0 where one id serves every query.  Ring inputs and
// every output are contiguous [Q, ...].
struct MatchArgs {
  int d, r, f;
  const float* det_boxes; long long det_boxes_sq;
  const float* det_feats; long long det_feats_sq;
  const unsigned char* valid; long long valid_sq;
  const void* video_id; int video_bytes; long long video_sq;
  const void* frame_id; int frame_bytes; long long frame_sq;
  const void* chunk_id; int chunk_bytes; long long chunk_sq;
  const float* boxes; const float* feats;
  const int* video; const int* frame; const int* chunk; const int* seen;
  const int* cursor; const int* total;
  float iou_thresh; long long time_gate;
  float* o_boxes; float* o_feats;
  int* o_video; int* o_frame; int* o_chunk; int* o_seen; int* o_cursor; int* o_total;
  int* cross_home; unsigned char* is_new; int* d0; int* d1; int* cross_chunk;
};

__device__ __forceinline__ long long load_id(const void* id, int bytes, long long sq, int q) {
  return bytes == 8 ? static_cast<const long long*>(id)[q * sq] : static_cast<const int*>(id)[q * sq];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// A features row of F floats, 16 bytes at a time where ``vec`` says that F
// is a multiple of 4 and every row is 16-byte aligned.
__device__ __forceinline__ void copy_row(float* dst, const float* src, int F, bool vec) {
  if (vec) {
    for (int c = 0; c < F; c += 4)
      *reinterpret_cast<float4*>(dst + c) = __ldg(reinterpret_cast<const float4*>(src + c));
  } else {
    for (int c = 0; c < F; ++c) dst[c] = __ldg(src + c);
  }
}

// (v, i) comes before (bv, bi): the larger IoU, or the lower slot at an
// equal one.  (-inf, INT_MAX) is "no eligible slot".
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The explicit 1 block an SM: with the maximum threads alone ptxas held the
// kernel to 32 registers and spilled.
__global__ void __cluster_dims__(kBlocks, 1, 1) __launch_bounds__(kThreads, 1)
match_update_kernel(const MatchArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / kBlocks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.d, R = a.r, F = a.f;
  const int per = (R + kBlocks - 1) / kBlocks;
  const int lo = min(rank * per, R), hi = min(lo + per, R);

  const size_t ring = static_cast<size_t>(q) * R;
  const float4* det = reinterpret_cast<const float4*>(a.det_boxes + q * a.det_boxes_sq);
  const float* det_feats = a.det_feats + q * a.det_feats_sq;
  const unsigned char* valid = a.valid + q * a.valid_sq;
  const long long vid = load_id(a.video_id, a.video_bytes, a.video_sq, q);
  const long long fid = load_id(a.frame_id, a.frame_bytes, a.frame_sq, q);
  const long long cid = load_id(a.chunk_id, a.chunk_bytes, a.chunk_sq, q);
  const float4* boxes = reinterpret_cast<const float4*>(a.boxes) + ring;
  const float* feats = a.feats + ring * F;
  const int* video = a.video + ring;
  const int* frame = a.frame + ring;
  const int* chunk = a.chunk + ring;
  const int* seen = a.seen + ring;

  __shared__ float4 sDet[kMaxD];
  __shared__ bool sValid[kMaxD];
  __shared__ float sWarpV[kWarps][kMaxD];   // each warp's first maximum a detection
  __shared__ int sWarpI[kWarps][kMaxD];
  __shared__ float sPartV[kMaxD];           // the block's: read by the whole cluster
  __shared__ int sPartI[kMaxD];
  __shared__ int sBest[kMaxD];              // the slot a detection bumps, -1 for none
  __shared__ int sNew[kMaxD];
  __shared__ int sNewAt[kMaxD];             // the k-th new detection
  __shared__ int sD0;
  __shared__ int sWarpCount[kWarps][2];
  __shared__ int sCount[2];                 // rank 0's: the cluster's d1, cross_chunk

  for (int i = tid; i < kWarps * kMaxD; i += kThreads) {
    (&sWarpV[0][0])[i] = -CUDART_INF_F;
    (&sWarpI[0][0])[i] = INT_MAX;
  }
  if (tid < D) {
    sDet[tid] = det[tid];
    sValid[tid] = valid[tid] != 0;
  }
  const int cursor = a.cursor[q];
  if (tid < 2) sCount[tid] = 0;
  if (tid == 0) sD0 = 0;
  __syncthreads();

  // Phase A: this block's first maximum of the eligible IoUs, a detection
  for (int base = lo; base < hi; base += kThreads) {
    const int r = base + tid;
    bool gate = false;
    float4 B = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < hi) {                                  // independent loads: one memory latency
      const int ts = __ldg(seen + r), vv = __ldg(video + r), fr = __ldg(frame + r);
      B = __ldg(boxes + r);
      const long long df = static_cast<long long>(fr) - fid;
      gate = ts > 0 && static_cast<long long>(vv) == vid && (df < 0 ? -df : df) <= a.time_gate;
    }
    if (!__any_sync(kFull, gate)) continue;
    for (int e = 0; e < D; ++e) {
      float v = -CUDART_INF_F;
      int i = INT_MAX;
      if (gate) {
        const float u = iou_of(sDet[e], B);
        if (u >= a.iou_thresh) { v = u; i = r; }
      }
      if (!__any_sync(kFull, i != INT_MAX)) continue;   // the usual case: nothing eligible
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, off);
        const int oi = __shfl_xor_sync(kFull, i, off);
        if (before(ov, oi, v, i)) { v = ov; i = oi; }
      }
      if (lane == 0 && before(v, i, sWarpV[warp][e], sWarpI[warp][e])) {
        sWarpV[warp][e] = v;
        sWarpI[warp][e] = i;
      }
    }
  }
  __syncthreads();
  if (tid < D) {
    float v = -CUDART_INF_F;
    int i = INT_MAX;
    for (int w = 0; w < kWarps; ++w)
      if (before(sWarpV[w][tid], sWarpI[w][tid], v, i)) { v = sWarpV[w][tid]; i = sWarpI[w][tid]; }
    sPartV[tid] = v;
    sPartI[tid] = i;
  }
  cluster.sync();                                  // every block's partial maxima are in

  // every block combines the cluster's partials for all D detections
  if (tid < D) {
    float v = -CUDART_INF_F;
    int i = INT_MAX;
    for (int b = 0; b < kBlocks; ++b) {
      const float pv = *cluster.map_shared_rank(&sPartV[tid], b);
      const int pi = *cluster.map_shared_rank(&sPartI[tid], b);
      if (before(pv, pi, v, i)) { v = pv; i = pi; }
    }
    const bool ok = sValid[tid], found = i != INT_MAX;
    sBest[tid] = ok && found ? i : -1;
    sNew[tid] = ok && !found;
  }
  __syncthreads();
  if (tid < D) {
    int order = 0;
    for (int e = 0; e < tid; ++e) order += sNew[e];
    if (sNew[tid]) sNewAt[order] = tid;
    if (tid == D - 1) sD0 = order + sNew[tid];
    if (rank == 0) a.is_new[static_cast<size_t>(q) * D + tid] = static_cast<unsigned char>(sNew[tid]);
  }
  __syncthreads();
  const int d0 = sD0;
  const long long cur = ((static_cast<long long>(cursor) % R) + R) % R;

  // Phase B: bumps, the 1 -> 2 transitions and each slot's new row
  int n_twice = 0, n_cross = 0;
  const bool vec = (F & 3) == 0 && aligned16(feats) && aligned16(det_feats) && aligned16(a.o_feats);
  for (int r = lo + tid; r < hi; r += kThreads) {
    // the slot's row, read before any store (the outputs never alias it)
    const int ts = __ldg(seen + r), ch = __ldg(chunk + r), vv = __ldg(video + r), fr = __ldg(frame + r);
    const float4 B = __ldg(boxes + r);
    const bool occ = ts > 0;
    int bump = 0;
    for (int e = 0; e < D; ++e) bump += sBest[e] == r;
    const int ns = ts + (occ ? bump : 0);
    const bool twice = occ && ts == 1 && ns >= 2;
    const bool crossed = twice && static_cast<long long>(ch) != cid;
    n_twice += twice;
    n_cross += crossed;
    a.cross_home[ring + r] = crossed ? ch : -1;
    long long k = r - cur;                         // the insert order that lands on r
    if (k < 0) k += R;
    float* of = a.o_feats + (ring + r) * F;
    if (k < d0) {
      k += static_cast<long long>(R) * ((d0 - 1 - k) / R);   // the last of them wins
      const int e = sNewAt[k];
      reinterpret_cast<float4*>(a.o_boxes)[ring + r] = sDet[e];
      copy_row(of, det_feats + static_cast<size_t>(e) * F, F, vec);
      a.o_video[ring + r] = static_cast<int>(vid);
      a.o_frame[ring + r] = static_cast<int>(fid);
      a.o_chunk[ring + r] = static_cast<int>(cid);
      a.o_seen[ring + r] = 1;
    } else {
      reinterpret_cast<float4*>(a.o_boxes)[ring + r] = B;
      copy_row(of, feats + static_cast<size_t>(r) * F, F, vec);
      a.o_video[ring + r] = vv;
      a.o_frame[ring + r] = fr;
      a.o_chunk[ring + r] = ch;
      a.o_seen[ring + r] = ns;
    }
  }
  n_twice = __reduce_add_sync(kFull, n_twice);
  n_cross = __reduce_add_sync(kFull, n_cross);
  if (lane == 0) {
    sWarpCount[warp][0] = n_twice;
    sWarpCount[warp][1] = n_cross;
  }
  __syncthreads();
  if (tid < 2) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += sWarpCount[w][tid];
    atomicAdd(cluster.map_shared_rank(&sCount[tid], 0), s);
  }
  cluster.sync();              // the counts are in, and no block's shared memory is read any more
  if (rank == 0 && tid == 0) {
    a.d0[q] = d0;
    a.d1[q] = sCount[0];
    a.cross_chunk[q] = sCount[1];
    a.o_cursor[q] = static_cast<int>((cur + d0) % R);
    a.o_total[q] = static_cast<int>(static_cast<unsigned>(a.total[q]) + static_cast<unsigned>(d0));
  }
}

}  // namespace

// a: f32[d, 4]; b: f32[r, 4], both 16-byte aligned; out: f32[d, r].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int iou_matrix_f32(const float* a, const float* b, int d, int r, float* out,
                              void* stream) {
  if (d <= 0 || r <= 0) return 0;
  const dim3 block(kTileR, kTileD);
  const dim3 grid((r + kTileR - 1) / kTileR, (d + kTileD - 1) / kTileD);
  iou_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b), d, r, out);
  return static_cast<int>(cudaGetLastError());
}

// a: f32[q, d, 4]; b: f32[q, r, 4], both 16-byte aligned; out: f32[q, d, r].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int iou_matrix_batched_f32(const float* a, const float* b, int q, int d, int r,
                                      float* out, void* stream) {
  if (q <= 0 || d <= 0 || r <= 0) return 0;
  const dim3 block(kTileR, kTileD);
  const dim3 grid((r + kTileR - 1) / kTileR, (d + kTileD - 1) / kTileD, q);
  iou_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b), d, r, out);
  return static_cast<int>(cudaGetLastError());
}

// One matcher step for each of q (frame, ring) pairs (see match_update_kernel).
// Detections: boxes f32[d, 4] (16-byte aligned, query stride a multiple of
// 4), feats f32[d, f], valid bool[d], each at its query stride in elements;
// ids int32 or int64 (bytes 4 or 8) at their query strides (0: shared).
// Ring: boxes f32[q, r, 4] (16-byte aligned), feats f32[q, r, f], video,
// frame, chunk, times_seen int32[q, r], cursor and total_inserted int32[q],
// all contiguous.  Outputs: the new ring in the same layout, cross_home
// int32[q, r], is_new bool[q, d], d0, d1 and cross_chunk int32[q], none
// aliasing an input.  Returns the CUDA error of the launch (0 on success).
extern "C" int match_update_f32(
    int q, int d, int r, int f,
    const float* det_boxes, long long det_boxes_sq, const float* det_feats, long long det_feats_sq,
    const unsigned char* valid, long long valid_sq,
    const void* video_id, int video_bytes, long long video_sq,
    const void* frame_id, int frame_bytes, long long frame_sq,
    const void* chunk_id, int chunk_bytes, long long chunk_sq,
    const float* boxes, const float* feats, const int* video, const int* frame, const int* chunk,
    const int* times_seen, const int* cursor, const int* total_inserted,
    float iou_thresh, long long time_gate,
    float* out_boxes, float* out_feats, int* out_video, int* out_frame, int* out_chunk,
    int* out_seen, int* out_cursor, int* out_total,
    int* cross_home, unsigned char* is_new, int* d0, int* d1, int* cross_chunk, void* stream) {
  if (q <= 0) return 0;
  const bool bytes_ok = (video_bytes == 4 || video_bytes == 8) && (frame_bytes == 4 || frame_bytes == 8) &&
                        (chunk_bytes == 4 || chunk_bytes == 8);
  if (d < 0 || d > kMaxD || r <= 0 || f < 0 || !bytes_ok || q > INT_MAX / kBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  MatchArgs a = {};
  a.d = d; a.r = r; a.f = f;
  a.det_boxes = det_boxes; a.det_boxes_sq = det_boxes_sq;
  a.det_feats = det_feats; a.det_feats_sq = det_feats_sq;
  a.valid = valid; a.valid_sq = valid_sq;
  a.video_id = video_id; a.video_bytes = video_bytes; a.video_sq = video_sq;
  a.frame_id = frame_id; a.frame_bytes = frame_bytes; a.frame_sq = frame_sq;
  a.chunk_id = chunk_id; a.chunk_bytes = chunk_bytes; a.chunk_sq = chunk_sq;
  a.boxes = boxes; a.feats = feats; a.video = video; a.frame = frame; a.chunk = chunk;
  a.seen = times_seen; a.cursor = cursor; a.total = total_inserted;
  a.iou_thresh = iou_thresh; a.time_gate = time_gate;
  a.o_boxes = out_boxes; a.o_feats = out_feats; a.o_video = out_video; a.o_frame = out_frame;
  a.o_chunk = out_chunk; a.o_seen = out_seen; a.o_cursor = out_cursor; a.o_total = out_total;
  a.cross_home = cross_home; a.is_new = is_new; a.d0 = d0; a.d1 = d1; a.cross_chunk = cross_chunk;
  match_update_kernel<<<q * kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
