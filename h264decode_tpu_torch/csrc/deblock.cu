// In-loop deblocking filter (H.264 spec 8.7), 4:2:0 8-bit, for Hopper.
//
// Replaces the Pallas TPU kernels of h264decode_tpu/kernels/deblock_pallas.py:
//   deblock_luma   <- _make_luma_kernel   (deblock_pallas.py:211)
//   deblock_chroma <- _make_chroma_kernel (deblock_pallas.py:295)
// called from deblock_frame_pallas (deblock_pallas.py:379). The plain
// version it is held against is h264decode_tpu_torch/kernels/deblock.py.
//
// What bounds it on this card: the filter runs in raster MB order, and
// each MB rewrites up to 3 columns of its left neighbour and 3 rows of its
// top neighbour, so MB (x, y) must run after (x-1, y), (x, y-1) and after
// (x+1, y-1) has filtered its left edge. On the 2:1 anti-diagonal
// d = mbx + 2*mby these lie on earlier diagonals, which leaves a serial
// chain of mb_w + 2*(mb_h - 1) steps (254 at 1080p). The bytes (one read and
// one write of the uint8 planes plus the per-cell edge parameters) take a
// few microseconds at 3.35 TB/s; the chain of launches bounds it.
//
// Design: one C entry per kernel loops over the diagonals on the host side
// and launches one block per MB of the diagonal on the caller's stream (one
// ctypes call per frame), and reports through *n_launched how many kernels
// it launched. A luma block has 16 threads: thread r filters
// line r across the 4 vertical edges left to right, then (after one
// __syncthreads()) thread c filters column c across the 4 horizontal edges
// top to bottom, which is the spec's order. Chroma: 16 threads, 8 lines
// per component, luma edges 0 and 2, tC = tC0 + 1, bS = 4 changes p0/q0
// only. A block whose MB has bS = 0 on every edge returns at once (the
// filter would be the identity), the counterpart of the Pallas kernels'
// skip of blocks whose bS are all zero. A persistent design is left for
// later.
//
// Data layout: planes y [H, W], cb/cr [Hc, Wc] uint8, filtered in place.
// Edge parameters per 4x4 cell edge, int32 [H4, W4] (chroma thresholds
// [2, H4, W4]), as kernels/deblock_prep_dev.py derives them: bs_v/bs_h,
// luma indexA/indexB ia_*/ib_*, chroma ca_*/cb_*. tabs = alpha[52],
// beta[52], tc0[52][3] (Table 8-16/8-17), int32. bS must be 0 on the
// picture's boundary edges (the prep guarantees it); the kernels never
// read outside the picture.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// One luma line across an edge: s points at q0, `step` is the distance
// between taps (1 across a vertical edge, the row pitch across a horizontal
// edge). Spec 8.7.2.3 (bS < 4) and 8.7.2.4 (bS = 4).
__device__ void filter_luma_line(uint8_t* s, int step, int bs, int ia, int ib,
                                 const int* __restrict__ tabs) {
  const int alpha = tabs[ia], beta = tabs[52 + ib];
  const int p0 = s[-step], p1 = s[-2 * step], p2 = s[-3 * step], p3 = s[-4 * step];
  const int q0 = s[0], q1 = s[step], q2 = s[2 * step], q3 = s[3 * step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta && iabs(q1 - q0) < beta)) return;
  const bool ap = iabs(p2 - p0) < beta, aq = iabs(q2 - q0) < beta;
  if (bs < 4) {
    const int tc0 = tabs[104 + ia * 3 + (bs < 3 ? bs : 3) - 1];
    const int tc = tc0 + ap + aq;
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[-step] = clip3(0, 255, p0 + delta);
    s[0] = clip3(0, 255, q0 - delta);
    const int avg = (p0 + q0 + 1) >> 1;
    if (ap) s[-2 * step] = p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1);
    if (aq) s[step] = q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1);
    return;
  }
  const bool strong = iabs(p0 - q0) < ((alpha >> 2) + 2);
  if (ap && strong) {
    s[-step] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
    s[-2 * step] = (p2 + p1 + p0 + q0 + 2) >> 2;
    s[-3 * step] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
  } else {
    s[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
  }
  if (aq && strong) {
    s[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
    s[step] = (q2 + q1 + q0 + p0 + 2) >> 2;
    s[2 * step] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
  } else {
    s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// One 4:2:0 chroma line: tC = tC0 + 1 (bS < 4); bS = 4 changes p0/q0 only.
__device__ void filter_chroma_line(uint8_t* s, int step, int bs, int ia, int ib,
                                   const int* __restrict__ tabs) {
  const int alpha = tabs[ia], beta = tabs[52 + ib];
  const int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta && iabs(q1 - q0) < beta)) return;
  if (bs < 4) {
    const int tc = tabs[104 + ia * 3 + (bs < 3 ? bs : 3) - 1] + 1;
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[-step] = clip3(0, 255, p0 + delta);
    s[0] = clip3(0, 255, q0 - delta);
  } else {
    s[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// true when any edge of MB (mbx, mby) has bS > 0 (uniform over the block)
__device__ bool mb_active(const int* bs_v, const int* bs_h, int W4, int mbx, int mby) {
  const int t = threadIdx.x;  // 16 threads: one 4x4 cell each
  const int cell = (4 * mby + (t >> 2)) * W4 + 4 * mbx + (t & 3);
  return __syncthreads_or(bs_v[cell] > 0 || bs_h[cell] > 0);
}

__global__ void __launch_bounds__(16) deblock_luma_diag(
    uint8_t* __restrict__ y, const int* __restrict__ bs_v, const int* __restrict__ bs_h,
    const int* __restrict__ ia_v, const int* __restrict__ ib_v,
    const int* __restrict__ ia_h, const int* __restrict__ ib_h,
    const int* __restrict__ tabs, int mb_h, int mb_w, int d, int mby0) {
  const int mby = mby0 + blockIdx.x, mbx = d - 2 * mby;
  const int W4 = 4 * mb_w, W = 16 * mb_w;
  if (!mb_active(bs_v, bs_h, W4, mbx, mby)) return;
  const int t = threadIdx.x;
  // vertical edges, left to right: thread t owns line (row) t
  for (int e = 0; e < 4; ++e) {
    const int x = 16 * mbx + 4 * e;
    const int cell = (4 * mby + (t >> 2)) * W4 + 4 * mbx + e;
    const int bs = bs_v[cell];
    if (bs > 0 && x > 0)
      filter_luma_line(y + (16 * mby + t) * W + x, 1, bs, ia_v[cell], ib_v[cell], tabs);
  }
  __syncthreads();
  // horizontal edges, top to bottom: thread t owns column t
  for (int e = 0; e < 4; ++e) {
    const int r = 16 * mby + 4 * e;
    const int cell = (4 * mby + e) * W4 + 4 * mbx + (t >> 2);
    const int bs = bs_h[cell];
    if (bs > 0 && r > 0)
      filter_luma_line(y + r * W + 16 * mbx + t, W, bs, ia_h[cell], ib_h[cell], tabs);
  }
}

__global__ void __launch_bounds__(16) deblock_chroma_diag(
    uint8_t* __restrict__ cb, uint8_t* __restrict__ cr, const int* __restrict__ bs_v,
    const int* __restrict__ bs_h, const int* __restrict__ ca_v, const int* __restrict__ cb_v,
    const int* __restrict__ ca_h, const int* __restrict__ cb_h,
    const int* __restrict__ tabs, int mb_h, int mb_w, int d, int mby0) {
  const int mby = mby0 + blockIdx.x, mbx = d - 2 * mby;
  const int W4 = 4 * mb_w, H4 = 4 * mb_h, Wc = 8 * mb_w;
  if (!mb_active(bs_v, bs_h, W4, mbx, mby)) return;
  const int comp = threadIdx.x >> 3, t = threadIdx.x & 7;
  uint8_t* pl = comp ? cr : cb;
  const int coff = comp * H4 * W4;  // component plane of the [2, H4, W4] grids
  // vertical chroma edges at luma edges 0 and 2: chroma line t uses luma cell row t/2
  for (int ei = 0; ei < 2; ++ei) {
    const int x = 8 * mbx + 4 * ei;
    const int cell = (4 * mby + (t >> 1)) * W4 + 4 * mbx + 2 * ei;
    const int bs = bs_v[cell];
    if (bs > 0 && x > 0)
      filter_chroma_line(pl + (8 * mby + t) * Wc + x, 1, bs, ca_v[coff + cell],
                         cb_v[coff + cell], tabs);
  }
  __syncthreads();
  for (int ei = 0; ei < 2; ++ei) {
    const int r = 8 * mby + 4 * ei;
    const int cell = (4 * mby + 2 * ei) * W4 + 4 * mbx + (t >> 1);
    const int bs = bs_h[cell];
    if (bs > 0 && r > 0)
      filter_chroma_line(pl + r * Wc + 8 * mbx + t, Wc, bs, ca_h[coff + cell],
                         cb_h[coff + cell], tabs);
  }
}

inline int diag_lo(int d, int mb_w) {
  int lo = d - (mb_w - 1);
  return lo > 0 ? (lo + 1) / 2 : 0;
}

inline int diag_hi(int d, int mb_h) { return d / 2 < mb_h - 1 ? d / 2 : mb_h - 1; }

}  // namespace

extern "C" int deblock_luma(void* y, const void* bs_v, const void* bs_h, const void* ia_v,
                            const void* ib_v, const void* ia_h, const void* ib_h,
                            const void* tabs, int mb_h, int mb_w, void* stream,
                            int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  for (int d = 0; d < mb_w + 2 * (mb_h - 1); ++d) {  // 254 at 1080p
    int lo = diag_lo(d, mb_w), hi = diag_hi(d, mb_h);
    if (hi < lo) continue;
    deblock_luma_diag<<<hi - lo + 1, 16, 0, s>>>(
        static_cast<uint8_t*>(y), static_cast<const int*>(bs_v),
        static_cast<const int*>(bs_h), static_cast<const int*>(ia_v),
        static_cast<const int*>(ib_v), static_cast<const int*>(ia_h),
        static_cast<const int*>(ib_h), static_cast<const int*>(tabs), mb_h, mb_w, d, lo);
    ++*n_launched;
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

extern "C" int deblock_chroma(void* cb, void* cr, const void* bs_v, const void* bs_h,
                              const void* ca_v, const void* cb_v, const void* ca_h,
                              const void* cb_h, const void* tabs, int mb_h, int mb_w,
                              void* stream, int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  for (int d = 0; d < mb_w + 2 * (mb_h - 1); ++d) {  // 254 at 1080p
    int lo = diag_lo(d, mb_w), hi = diag_hi(d, mb_h);
    if (hi < lo) continue;
    deblock_chroma_diag<<<hi - lo + 1, 16, 0, s>>>(
        static_cast<uint8_t*>(cb), static_cast<uint8_t*>(cr),
        static_cast<const int*>(bs_v), static_cast<const int*>(bs_h),
        static_cast<const int*>(ca_v), static_cast<const int*>(cb_v),
        static_cast<const int*>(ca_h), static_cast<const int*>(cb_h),
        static_cast<const int*>(tabs), mb_h, mb_w, d, lo);
    ++*n_launched;
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
