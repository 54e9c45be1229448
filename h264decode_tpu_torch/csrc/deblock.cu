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
// (x+1, y-1) has filtered its left edge. That leaves a serial chain of
// mb_w + 2*(mb_h - 1) MB steps (254 at 1080p). The bytes (one read and one
// write of the uint8 planes plus the per-cell edge parameters) take a few
// microseconds at 3.35 TB/s; the time of one step of the chain (the
// hand-off between rows plus one MB's own latency) times 254 bounds it.
//
// Luma design (deblock_luma_rows): one persistent launch per call, one
// block of 16 threads per MB row, rows handed on through progress counters
// in device memory (wavefront.cuh); MB (x, y) waits until row y-1 has
// finished MB x+1. The block keeps a shared tile of its MB, the 4 columns to
// its left (carried over from the MB it filtered just before) and the 4 rows
// above; only the rows above come from device memory after the wait. The
// MB's own samples (no other block writes them before this block does) and
// its bS / indexA / indexB cells are loaded into registers one MB ahead, so
// they overlap the wait. In the tile, thread r filters line r across the 4
// vertical edges left to right, then (after one __syncthreads()) thread c
// filters column c across the 4 horizontal edges top to bottom, which is
// the spec's order; then the MB, its left strip and its top strip go back
// to the plane. Only the top edge reads or writes row y-1's samples, so the
// vertical edges run before the wait, and an MB whose top edge has bS = 0
// does not wait at all. An MB with bS = 0 on every edge neither waits nor
// writes (the filter would be the identity), the counterpart of the Pallas
// kernels' skip of blocks whose bS are all zero; it only publishes.
//
// Chroma design (deblock_chroma_rows): the same row wavefront and hand-off
// (a 4:2:0 chroma MB is 8x8 per component and MB (x, y) still waits for
// row y-1 to finish MB x+1, so its chain is the same 254 steps), one block
// of 16 threads per MB row: 8 lines of Cb and 8 of Cr. Only luma edges 0
// and 2 carry chroma edges; tC = tC0 + 1, and bS = 4 changes p0/q0 only.
// The block keeps each component's MB in a shared tile with the left MB's
// last 2 columns carried along the row; only the 2 rows above come from
// device memory, after the wait. The next MB's 8-byte lines and its chroma
// edge parameters (8 bs_v and 8 bs_h cells, indexA / indexB of both
// components) are loaded one MB ahead. Vertical edges run before the wait;
// the wait is skipped when the MB's chroma top edge has bS = 0, and an MB
// with bS = 0 on all its chroma edges neither waits nor writes.
//
// The C entry points take the caller's stream and report through
// *n_launched how many kernels they launched (1 each).
//
// Data layout: planes y [H, W], cb/cr [Hc, Wc] uint8, filtered in place.
// Edge parameters per 4x4 cell edge, int32 [H4, W4] (chroma thresholds
// [2, H4, W4]), as kernels/deblock_prep_dev.py derives them: bs_v/bs_h,
// luma indexA/indexB ia_*/ib_*, chroma ca_*/cb_*. tabs = alpha[52],
// beta[52], tc0[52][3] (Table 8-16/8-17), int32. bS must be 0 on the
// picture's boundary edges (the prep guarantees it); the kernels never
// read outside the picture. Each entry also takes sync, int32[mb_h + 1] of
// scratch, which it zeroes on the stream before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

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

// 16 bytes of a 4-byte-aligned shared row, as 4 words
__device__ __forceinline__ void put16(uint8_t* dst, uint4 v) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

__device__ __forceinline__ uint4 get16(const uint8_t* src) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  return make_uint4(s[0], s[1], s[2], s[3]);
}

// Luma: one block of 16 threads per MB row. tile[r][c] holds picture sample
// (16*row - 4 + r, 16*mbx - 4 + c): rows 0..3 the rows above the MB
// (columns 4..19 only), columns 0..3 the left MB's last 4 columns (rows
// 4..19 only), rows/columns 4..19 the MB. prm[k][cell] holds the MB's 16
// cells of bs_v, ia_v, ib_v, bs_h, ia_h, ib_h (cell = 4 * cell row + cell col).
__global__ void __launch_bounds__(16) deblock_luma_rows(
    uint8_t* y, const int* __restrict__ bs_v, const int* __restrict__ bs_h,
    const int* __restrict__ ia_v, const int* __restrict__ ib_v,
    const int* __restrict__ ia_h, const int* __restrict__ ib_h,
    const int* __restrict__ tabs, int* sync, int mb_h, int mb_w) {
  __shared__ __align__(16) uint8_t tile[20][20];
  __shared__ int prm[6][16];
  const int row = wavefront::take_row(sync);
  const int W = 16 * mb_w, W4 = 4 * mb_w;
  const int t = threadIdx.x;
  const int* grids[6] = {bs_v, ia_v, ib_v, bs_h, ia_h, ib_h};
  const int cell0 = (4 * row + (t >> 2)) * W4 + (t & 3);  // thread t's cell of MB 0
  uint8_t* line = y + (16 * row + t) * W;                  // thread t's MB line
  // MB 0, one MB ahead: line t of its samples and cell t of its parameters
  uint4 nline = __ldcg(reinterpret_cast<const uint4*>(line));
  int ncell[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) ncell[k] = __ldg(grids[k] + cell0);
  for (int mbx = 0; mbx < mb_w; ++mbx) {
    put16(&tile[4 + t][4], nline);
#pragma unroll
    for (int k = 0; k < 6; ++k) prm[k][t] = ncell[k];
    const bool active = __syncthreads_or(ncell[0] > 0 || ncell[3] > 0);
    if (mbx + 1 < mb_w) {
      nline = __ldcg(reinterpret_cast<const uint4*>(line + 16 * (mbx + 1)));
#pragma unroll
      for (int k = 0; k < 6; ++k) ncell[k] = __ldg(grids[k] + cell0 + 4 * (mbx + 1));
    }
    if (active) {
      // vertical edges, left to right: thread t owns line t. They touch
      // this row's lines only (the tile), so they run before the wait.
      for (int e = 0; e < 4; ++e) {
        const int c = (t >> 2) * 4 + e, bs = prm[0][c];
        if (bs > 0 && (mbx > 0 || e > 0))
          filter_luma_line(&tile[4 + t][4 + 4 * e], 1, bs, prm[1][c], prm[2][c], tabs);
      }
      // Why the vertical edges may run before the wait, and an MB with a
      // bS = 0 top edge may skip it (a chroma port must not copy the skip
      // without this footprint argument): MB (x, row) writes lines
      // 16*row-3 .. 16*row+15 of columns 16x-4 .. 16x+15, and only its top
      // edge touches lines of row-1. No block of row-1 ever reads or writes
      // a line of this row. Row+1's MB x' writes this row's last 3 lines,
      // columns 16x' .. 16x'+15, only after this row has published x'+2
      // MBs, so nothing but this block has written columns 16x-4 .. 16x+15
      // of this row's lines when it loads them (one MB ahead) or filters
      // them. Row-1's lines under MB x are final only once row-1
      // has finished MB x+1 (its left-edge filter rewrites columns
      // 16x+12 .. 16x+15): hence the wait, before the top edge alone.
      const bool top = row > 0 && (prm[3][0] | prm[3][1] | prm[3][2] | prm[3][3]) > 0;
      if (top) {
        wavefront::wait_row(sync, row, min(mbx + 2, mb_w));
        if (t < 4)
          put16(&tile[t][4], __ldcg(reinterpret_cast<const uint4*>(
                                 y + (16 * row - 4 + t) * W + 16 * mbx)));
      }
      __syncthreads();
      // horizontal edges, top to bottom: thread t owns column t
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * e + (t >> 2), bs = prm[3][c];
        if (bs > 0 && (row > 0 || e > 0))
          filter_luma_line(&tile[4 + 4 * e][4 + t], 20, bs, prm[4][c], prm[5][c], tabs);
      }
      __syncthreads();
      // back to the plane: line t with the left strip, rows -3..-1 above
      uint8_t* g = line + 16 * mbx;
      if (mbx > 0) *reinterpret_cast<uint32_t*>(g - 4) =
                       *reinterpret_cast<const uint32_t*>(&tile[4 + t][0]);
      *reinterpret_cast<uint4*>(g) = get16(&tile[4 + t][4]);
      if (top && t < 3)
        *reinterpret_cast<uint4*>(y + (16 * row - 3 + t) * W + 16 * mbx) =
            get16(&tile[1 + t][4]);
    }
    // the MB's last 4 columns are the next MB's left strip (own line only)
    *reinterpret_cast<uint32_t*>(&tile[4 + t][0]) =
        *reinterpret_cast<const uint32_t*>(&tile[4 + t][16]);
    wavefront::publish_row(sync, row, mbx + 1);
  }
}

// Chroma: one block of 16 threads per MB row; thread t filters line t & 7
// of component t >> 3 (0 Cb, 1 Cr) across the vertical edges and column
// t & 7 across the horizontal ones. tile[c][r][k] holds picture sample
// (8*row - 2 + r, 8*mbx - 8 + k) of component c: rows 0..1 the rows above
// the MB (columns 8..15 only), columns 6..7 the left MB's last 2 columns
// (rows 2..9 only), rows 2..9 / columns 8..15 the MB, 8-byte aligned. Only
// luma edges 0 and 2 carry chroma edges (4:2:0): thread t's parameters are
// the cells of its line (bs_v at cell row (t & 7) / 2, cell columns 0 and 2)
// and of its column (bs_h at cell rows 0 and 2, cell column (t & 7) / 2),
// with its component's indexA / indexB. bS on luma edges 1 and 3 alone gives
// the MB no chroma work.
__global__ void __launch_bounds__(16) deblock_chroma_rows(
    uint8_t* cb, uint8_t* cr, const int* __restrict__ bs_v, const int* __restrict__ bs_h,
    const int* __restrict__ ca_v, const int* __restrict__ cb_v,
    const int* __restrict__ ca_h, const int* __restrict__ cb_h,
    const int* __restrict__ tabs, int* sync, int mb_h, int mb_w) {
  __shared__ __align__(16) uint8_t tile[2][10][16];
  const int row = wavefront::take_row(sync);
  const int Wc = 8 * mb_w, W4 = 4 * mb_w, H4 = 4 * mb_h;
  const int c = threadIdx.x >> 3, t = threadIdx.x & 7;
  uint8_t (*tl)[16] = tile[c];
  uint8_t* pl = c ? cr : cb;
  const int coff = c * H4 * W4;  // component plane of the [2, H4, W4] grids
  const int vcell = (4 * row + (t >> 1)) * W4;   // + 4*mbx + 2*ei: line t's cells
  const int hcell = 4 * row * W4 + (t >> 1);     // + 2*ei*W4 + 4*mbx: column t's
  uint8_t* line = pl + (8 * row + t) * Wc;       // thread t's MB line
  // MB 0, one MB ahead: line t of its samples, the bS / indexA / indexB of
  // its line's two vertical and its column's two horizontal chroma edges
  uint2 nline = __ldcg(reinterpret_cast<const uint2*>(line));
  int nv[3][2], nh[3][2];
  auto fetch = [&](int mbx) {
#pragma unroll
    for (int ei = 0; ei < 2; ++ei) {
      const int v = vcell + 4 * mbx + 2 * ei, h = hcell + 2 * ei * W4 + 4 * mbx;
      nv[0][ei] = __ldg(bs_v + v);
      nv[1][ei] = __ldg(ca_v + coff + v);
      nv[2][ei] = __ldg(cb_v + coff + v);
      nh[0][ei] = __ldg(bs_h + h);
      nh[1][ei] = __ldg(ca_h + coff + h);
      nh[2][ei] = __ldg(cb_h + coff + h);
    }
  };
  fetch(0);
  for (int mbx = 0; mbx < mb_w; ++mbx) {
    *reinterpret_cast<uint2*>(&tl[2 + t][8]) = nline;
    int pv[3][2], ph[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int ei = 0; ei < 2; ++ei) { pv[k][ei] = nv[k][ei]; ph[k][ei] = nh[k][ei]; }
    const bool active = __syncthreads_or((pv[0][0] | pv[0][1] | ph[0][0] | ph[0][1]) > 0);
    if (mbx + 1 < mb_w) {
      nline = __ldcg(reinterpret_cast<const uint2*>(line + 8 * (mbx + 1)));
      fetch(mbx + 1);
    }
    if (active) {
      // vertical edges, left to right: thread t owns line t of its
      // component. They touch this row's lines only, so they run before
      // the wait.
#pragma unroll
      for (int ei = 0; ei < 2; ++ei)
        if (pv[0][ei] > 0 && (mbx > 0 || ei > 0))
          filter_chroma_line(&tl[2 + t][8 + 4 * ei], 1, pv[0][ei], pv[1][ei], pv[2][ei], tabs);
      // Why the vertical edges may run before the wait, and an MB whose
      // chroma top edge has bS = 0 may skip it. In chroma samples, MB
      // (x, row) reads lines 8*row-2 .. 8*row+7 of columns 8x-2 .. 8x+7 and
      // writes lines 8*row-1 .. 8*row+7 of columns 8x-1 .. 8x+7; only its
      // top edge reads or writes lines of row-1. No block of row-1 ever
      // reads or writes a line of this row. Row+1's MB x' writes line
      // 8*row+7 of columns 8x' .. 8x'+7 (and reads lines 8*row+6, +7 there)
      // only after this row has published x'+2 MBs, so nothing but this
      // block has written columns 8x-2 .. 8x+7 of this row's lines when it
      // loads them (one MB ahead) or filters them. Row-1's lines under MB x
      // are final only once row-1 has finished MB x+1, whose left-edge
      // filter rewrites column 8x+7 of lines 8*row-8 .. 8*row-1: hence
      // need = x+2, before the top edge alone.
      const bool top = __syncthreads_or(row > 0 && ph[0][0] > 0);
      if (top) {
        wavefront::wait_row(sync, row, min(mbx + 2, mb_w));
        if (t < 2)
          *reinterpret_cast<uint2*>(&tl[t][8]) = __ldcg(
              reinterpret_cast<const uint2*>(pl + (8 * row - 2 + t) * Wc + 8 * mbx));
      }
      __syncthreads();
      // horizontal edges, top to bottom: thread t owns column t
#pragma unroll
      for (int ei = 0; ei < 2; ++ei)
        if (ph[0][ei] > 0 && (row > 0 || ei > 0))
          filter_chroma_line(&tl[2 + 4 * ei][8 + t], 16, ph[0][ei], ph[1][ei], ph[2][ei], tabs);
      __syncthreads();
      // Back to the plane, nothing deferred: line t with the left MB's last
      // column (the left edge's p0), and the line above (the top edge's p0).
      // So when this row publishes n, MBs 0..n-1 are in the plane, each but
      // MB n-1 with the column its right neighbour's left edge rewrote;
      // need = x+2 above waits for exactly that.
      uint8_t* g = line + 8 * mbx;
      if (mbx > 0) g[-1] = tl[2 + t][7];
      *reinterpret_cast<uint2*>(g) = *reinterpret_cast<const uint2*>(&tl[2 + t][8]);
      if (top && t == 0)
        *reinterpret_cast<uint2*>(pl + (8 * row - 1) * Wc + 8 * mbx) =
            *reinterpret_cast<const uint2*>(&tl[1][8]);
    }
    // the MB's last 2 columns are the next MB's left strip (own line only)
    *reinterpret_cast<uint16_t*>(&tl[2 + t][6]) =
        *reinterpret_cast<const uint16_t*>(&tl[2 + t][14]);
    wavefront::publish_row(sync, row, mbx + 1);
  }
}

}  // namespace

extern "C" int deblock_luma(void* y, const void* bs_v, const void* bs_h, const void* ia_v,
                            const void* ib_v, const void* ia_h, const void* ib_h,
                            const void* tabs, void* sync, int mb_h, int mb_w, void* stream,
                            int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (mb_h + 1), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  deblock_luma_rows<<<mb_h, 16, 0, s>>>(
      static_cast<uint8_t*>(y), static_cast<const int*>(bs_v), static_cast<const int*>(bs_h),
      static_cast<const int*>(ia_v), static_cast<const int*>(ib_v),
      static_cast<const int*>(ia_h), static_cast<const int*>(ib_h),
      static_cast<const int*>(tabs), static_cast<int*>(sync), mb_h, mb_w);
  *n_launched = 1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int deblock_chroma(void* cb, void* cr, const void* bs_v, const void* bs_h,
                              const void* ca_v, const void* cb_v, const void* ca_h,
                              const void* cb_h, const void* tabs, void* sync, int mb_h,
                              int mb_w, void* stream, int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (mb_h + 1), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  deblock_chroma_rows<<<mb_h, 16, 0, s>>>(
      static_cast<uint8_t*>(cb), static_cast<uint8_t*>(cr), static_cast<const int*>(bs_v),
      static_cast<const int*>(bs_h), static_cast<const int*>(ca_v),
      static_cast<const int*>(cb_v), static_cast<const int*>(ca_h),
      static_cast<const int*>(cb_h), static_cast<const int*>(tabs), static_cast<int*>(sync),
      mb_h, mb_w);
  *n_launched = 1;
  return static_cast<int>(cudaGetLastError());
}
