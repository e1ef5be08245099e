// The tensor-core primitives that B4's float32 bodies share: the forward's
// "wgmma_f32" (flash_attention.cu) and its backward (flash_attention_bwd.cu).
//
// cp.async copies into wgmma's no-swizzle (INTERLEAVE) layout, the
// descriptors of that layout, wgmma's fences, commits and waits, and its
// TF32 products: m64n{16,32,48,64,96,128,256}k8 with A from registers and
// m64n32k8 with both operands in shared memory, each .f32.tf32.tf32 with
// float32 accumulators.  A float32 operand x enters as x_hi = tf32(x) and
// x_lo = tf32(x - x_hi), both by cvt.rna (to nearest, ties away from
// zero); a.b is then a_hi.b_hi + a_hi.b_lo + a_lo.b_hi ("3xTF32").  TF32
// operands are read K-major only (no transpose bit), in k-steps of 8
// values: two 16-byte chunks, 256 bytes apart in the layout, so a k-step's
// descriptor is the previous one plus 16.  The staging helpers take the
// block's thread count as THREADS.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tfw {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// threads' writes to shared memory (cp.async, stores) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of wgmma's registers across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Descriptor of a no-swizzle (INTERLEAVE, layout type 0) operand in shared
// memory: core matrices of 8 rows x 16 bytes, 128 contiguous bytes each;
// lbo = bytes between core matrices adjacent in K, sbo = adjacent in M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 .. r0+ROWS-1 of a [rows, DC*16 bytes] view of bfloat16 or
// float32 (row stride in elements) into the INTERLEAVE layout with LDC
// chunks of 16 bytes a row (LDC >= DC): the chunk at (row r, chunk c)
// lands at ((r/8)*LDC + c)*128 + (r%8)*16, one cp.async.cg each, the 8 rows
// of a core matrix on neighbouring threads so that a warp writes 512
// contiguous bytes.  Rows at or past n_valid, and chunks at or past c_valid
// (a row narrower than DC chunks), are zero-filled.
template <int THREADS, int ROWS, int DC, int LDC, typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src, long long row_stride,
                                          int r0, int n_valid, int c_valid = DC) {
  constexpr int kChunks = ROWS * DC;
#pragma unroll
  for (int n = 0; n < (kChunks + THREADS - 1) / THREADS; ++n) {
    const int i = n * THREADS + threadIdx.x;
    if (kChunks % THREADS != 0 && i >= kChunks) break;
    const int r8 = i % 8, c = (i / 8) % DC, g = i / (8 * DC);
    const int r = g * 8 + r8;
    unsigned char* p = dst + (g * LDC + c) * 128 + r8 * 16;
    if (r0 + r < n_valid && c < c_valid)
      cp_async16(p, src + static_cast<long long>(r0 + r) * row_stride + c * (16 / sizeof(T)));
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// x rounded to TF32 by cvt.rna (to nearest, ties away from zero), the low
// 13 bits cleared, so that the value is the one wgmma reads
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

#define TF_ACC8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define TF_ACC16                                                                                   \
  TF_ACC8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15])
#define TF_ACC24                                                                                   \
  TF_ACC16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23])
#define TF_ACC32                                                                                   \
  TF_ACC16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),   \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TF_ACC48                                                                                   \
  TF_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),          \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define TF_ACC64                                                                                   \
  TF_ACC48, "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),          \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),   \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TF_ACC128                                                                                  \
  TF_ACC64, "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),          \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),   \
      "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),   \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),   \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),   \
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),            \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),          \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),          \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),          \
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define TF_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TF_REGS16 TF_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define TF_REGS24 TF_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define TF_REGS32 TF_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TF_REGS48 TF_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define TF_REGS64 TF_REGS48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define TF_REGS128 \
  TF_REGS64 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79" \
  ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111" \
  ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// D (+)= A.B, wgmma m64n{N}k8 with NACC = N/2 accumulators a thread: A (4
// tf32 a thread) from registers, B (K-major) from shared memory; the first
// product of a sum passes accumulate = 0 and overwrites d.  The forward's
// O += P.V^T at N = DN and, above d = 128, S = Q.K^T at N = 32; the
// backward's products at N = 32 and at its warpgroups' column widths.
#define TF_MMA_RS(NACC, N, REGS, ACC, A0, A1, A2, A3, B, P)                                      \
  __device__ __forceinline__ void mma_rs(float (&d)[NACC], const uint32_t (&a)[4], uint64_t b,    \
                                         int accumulate = 1) {                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, "           \
                 "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1;\n}\n"                \
                 : ACC                                                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }
TF_MMA_RS(8, 16, TF_REGS8, TF_ACC8, 8, 9, 10, 11, 12, 13)
TF_MMA_RS(16, 32, TF_REGS16, TF_ACC16, 16, 17, 18, 19, 20, 21)
TF_MMA_RS(24, 48, TF_REGS24, TF_ACC24, 24, 25, 26, 27, 28, 29)
TF_MMA_RS(32, 64, TF_REGS32, TF_ACC32, 32, 33, 34, 35, 36, 37)
TF_MMA_RS(48, 96, TF_REGS48, TF_ACC48, 48, 49, 50, 51, 52, 53)
TF_MMA_RS(64, 128, TF_REGS64, TF_ACC64, 64, 65, 66, 67, 68, 69)
TF_MMA_RS(128, 256, TF_REGS128, TF_ACC128, 128, 129, 130, 131, 132, 133)
#undef TF_MMA_RS

// S (+)= Q.K^T, wgmma m64n32k8, A and B from shared memory, both K-major
// (tf32 has no transpose bit)
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" TF_REGS16 "}, %16, %17, p, 1, 1;\n}\n"
               : TF_ACC16
               : "l"(a), "l"(b), "r"(accumulate));
}

// Waits until at most N committed groups of this warpgroup's wgmmas are
// still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The warp's four 8 x 4 float32 matrices at the four row addresses its
// lanes give (lanes 8i .. 8i+7 the rows of matrix i): lane l receives row
// l/4, column l%4 of each, in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Keys k0 .. k0+KEYS-1 of a [keys, D] float32 view as V^T: row n (a
// head-dim column) holds the tile's keys contiguous, so that P.V reads V
// K-major.  Within each 8-key slice the keys are permuted: key j sits at
// position (j%2)*4 + j/2, because the S accumulator gives a thread keys
// (2t, 2t+1) of the slice and P's A fragment wants positions (t, t+4) (see
// flash_attention.cu's note).  One 4-byte cp.async a value; a warp copies 8 columns x 4 keys
// of one parity, which land on 32 distinct banks.  Keys at or past n_valid
// and columns at or past d_valid are 0.
template <int THREADS, int D, int KEYS>
__device__ __forceinline__ void load_vt(unsigned char* dst, const float* src, long long row_stride,
                                        int k0, int n_valid, int d_valid) {
  constexpr int kQuads = KEYS / 4;                 // (8 columns) x (4 keys of a slice and parity)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nl = lane % 8, m = lane / 8;
#pragma unroll 4
  for (int item = warp; item < (D / 8) * kQuads; item += THREADS / 32) {
    const int g8 = item / kQuads, quad = item % kQuads;
    const int slice = quad / 2, parity = quad % 2;
    const int key = k0 + 8 * slice + 2 * m + parity, col = g8 * 8 + nl;
    unsigned char* p = dst + ((g8 * kQuads + 2 * slice + parity) * 128 + nl * 16 + m * 4);
    if (key < n_valid && col < d_valid)
      cp_async4(p, src + static_cast<long long>(key) * row_stride + col);
    else
      *reinterpret_cast<float*>(p) = 0.f;
  }
}

// In place: each raw float32 x in lo becomes tf32(x) in hi and
// tf32(x - tf32(x)) in lo, at the same offset (BYTES of each).
template <int THREADS, int BYTES, int UNROLL = 4>
__device__ __forceinline__ void split(unsigned char* hi, unsigned char* lo) {
#pragma unroll (UNROLL)
  for (int i = threadIdx.x * 16; i < BYTES; i += THREADS * 16) {
    const float4 x = *reinterpret_cast<const float4*>(lo + i);
    const float4 h = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    *reinterpret_cast<float4*>(hi + i) = h;
    *reinterpret_cast<float4*>(lo + i) =
        make_float4(tf32(x.x - h.x), tf32(x.y - h.y), tf32(x.z - h.z), tf32(x.w - h.w));
  }
}

}  // namespace tfw
}  // namespace
