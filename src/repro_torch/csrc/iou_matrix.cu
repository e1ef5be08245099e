// Pairwise IoU matrix for the ExSample detection matcher.
//
// Replaces the TPU kernel src/repro/kernels/iou_match/kernel.py::iou_matrix
// (body _iou_kernel): out[d, r] = IoU of box a[d] and box b[r], boxes as
// (x0, y0, x1, y1), widths and heights clamped at 0,
//     union = area_a + area_b - inter,   out = inter / max(union, 1e-9).
//
// Design: a 2-D grid of (32 R-columns x 8 D-rows) tiles, one output per
// thread, each box read as one float4; neighbouring threads write
// neighbouring columns, so stores coalesce.  The arithmetic follows the
// reference operation for operation with explicitly rounded intrinsics,
// except at the one site where the jitted reference's CPU backend fuses a
// multiply into the add (area_b's product into area_a + area_b): there the
// kernel uses fmaf, and the plain version an exact float32 FMA, so kernel,
// plain version and jitted reference agree bit for bit.
//
// Bound on the H100: at the main path's D=16 detections and R=8192 ring
// slots a launch reads 16*16 + 8192*16 B = 131 KB and writes 16*8192*4 B =
// 524 KB (0.2 us at 3.35 TB/s), with ~20 flops per output (2.6 MFLOP, 0.04
// us at 67 TFLOP/s f32).  It is bound by launch latency; fusing the
// matcher's gating and argmax into it is later work.
//
// The batched entry runs Q independent matrices in one launch (blockIdx.z
// is the query: out[q] = IoU(a[q], b[q]) with the same per-element code),
// for the multi-query matcher's one launch per cohort slot.  At (Q, D, R) =
// (8, 16, 8192) it moves Q(16D + 16R + 4DR) = 5.24 MB, 1.57 us at 3.35
// TB/s, again well under a launch.
#include <cuda_runtime.h>

namespace {

constexpr int kTileR = 32;
constexpr int kTileD = 8;

__global__ void __launch_bounds__(kTileR * kTileD)
iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b, int d, int r,
                  float* __restrict__ out) {
  const int j = blockIdx.x * kTileR + threadIdx.x;
  const int i = blockIdx.y * kTileD + threadIdx.y;
  if (i >= d || j >= r) return;
  a += static_cast<size_t>(blockIdx.z) * d;   // this query's matrices
  b += static_cast<size_t>(blockIdx.z) * r;
  out += static_cast<size_t>(blockIdx.z) * d * r;
  const float4 A = a[i];
  const float4 B = b[j];
  const float aw = fmaxf(__fsub_rn(A.z, A.x), 0.0f);
  const float ah = fmaxf(__fsub_rn(A.w, A.y), 0.0f);
  const float bw = fmaxf(__fsub_rn(B.z, B.x), 0.0f);
  const float bh = fmaxf(__fsub_rn(B.w, B.y), 0.0f);
  const float area_a = __fmul_rn(aw, ah);
  const float iw = fmaxf(__fsub_rn(fminf(A.z, B.z), fmaxf(A.x, B.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(A.w, B.w), fmaxf(A.y, B.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(fmaf(bw, bh, area_a), inter);
  out[static_cast<size_t>(i) * r + j] = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
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
