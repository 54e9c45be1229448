// In-loop deblocking filter (H.264 spec 8.7) for Hopper: 4:2:0 and 4:2:2
// (ChromaArrayType 1 and 2, also 0 = monochrome run as 4:2:0), uint8
// samples at 8 bits and uint16 samples at 9 to 14 bits, and 8-bit 4:4:4
// (ChromaArrayType 3), whose Cb and Cr planes take the luma filter
// (chromaStyleFilteringFlag = 0) in the luma kernel's launch.
//
// Replaces the Pallas TPU kernels of h264decode_tpu/kernels/deblock_pallas.py:
//   deblock_luma   <- _make_luma_kernel   (deblock_pallas.py:211)
//   deblock_chroma <- _make_chroma_kernel (deblock_pallas.py:295)
// called from deblock_frame_pallas (deblock_pallas.py:379). Those are 4:2:0
// 8-bit only; the JAX package runs 4:2:2 and high bit depths through the
// XLA wavefront deblock_frame_tpu(ch_h, bd_scale, mx) (kernels/deblock.py:111).
// The plain version this file is held against is
// h264decode_tpu_torch/kernels/deblock.py, which covers every format. For
// 4:4:4 the JAX package calls deblock_frame_pallas once per plane with dummy
// chroma, each plane with its own QP grid (tpu_pipeline.py:482-496); here
// deblock_luma filters the three planes in one launch and the chroma kernel
// does not run.
//
// The format enters as template parameters, the sample type T (uint8_t or
// uint16_t) and the chroma MB height CH_H (8 or 16), and as arguments:
// bd_scale = 1 << (bd - 8), which multiplies alpha, beta and tC0 (8.7.2.2),
// and the Clip1 ceiling mx = (1 << bd) - 1. The uint8_t instantiations fold
// both to 1 and 255.
//
// What bounds it on this card: the filter runs in raster MB order, and
// each MB rewrites up to 3 columns of its left neighbour and 3 rows of its
// top neighbour, so MB (x, y) must run after (x-1, y), (x, y-1) and after
// (x+1, y-1) has filtered its left edge. That leaves a serial chain of
// mb_w + 2*(mb_h - 1) MB steps (254 at 1080p). The bytes (one read and one
// write of the planes plus the per-cell edge parameters) take a few
// microseconds at 3.35 TB/s; the time of one step of the chain (the
// hand-off between rows plus one MB's own latency) times 254 bounds it.
//
// Luma design (deblock_luma_rows<T>): one persistent launch per call, one
// block of 16 threads per MB row of each of P planes (P = 1, or 3 for 4:4:4:
// the planes share bS, each has its own indexA / indexB grid from its own
// QP), rows handed on through each plane's progress counters in device
// memory (wavefront.cuh); MB (x, y) waits until row y-1 of its plane has
// finished MB x+1. The planes' chains are independent and run side by side. The block keeps a shared tile of its MB, the 4 columns to
// its left (carried over from the MB it filtered just before) and the 4 rows
// above; only the rows above come from device memory after the wait. The
// MB's own samples (no other block writes them before this block does) and
// its bS / indexA / indexB cells are loaded into registers one MB ahead, so
// they overlap the wait; a line of 16 samples moves as one 16-byte vector
// (uint8_t) or two (uint16_t). In the tile, thread r filters line r across
// the 4 vertical edges left to right, then (after one __syncthreads())
// thread c filters column c across the 4 horizontal edges top to bottom,
// which is the spec's order; then the MB, its left strip and its top strip
// go back to the plane. Only the top edge reads or writes row y-1's
// samples, so the vertical edges run before the wait, and an MB whose top
// edge has bS = 0 does not wait at all. An MB with bS = 0 on every edge
// neither waits nor writes (the filter would be the identity), the
// counterpart of the Pallas kernels' skip of blocks whose bS are all zero;
// it only publishes.
//
// Chroma design (deblock_chroma_rows<T, CH_H>): the same row wavefront and
// hand-off (MB (x, y) waits for row y-1 to finish MB x+1, so its chain is
// the same 254 steps), one block of 2 * CH_H threads per MB row: CH_H lines
// of Cb and CH_H of Cr. Vertical chroma edges sit at chroma columns 0 and 4
// (luma edges 0 and 2); chroma line j takes the bS of luma cell row
// j / (CH_H / 4). Horizontal chroma edges sit at chroma rows 0 and 4 for
// 4:2:0 (luma edges 0 and 2, bs_h) and at rows 0, 4, 8 and 12 for 4:2:2
// (luma cell rows 0..3, bs_hc: the bS without the 8x8-transform
// suppression). tC = tC0 * bd_scale + 1, and bS = 4 changes p0/q0 only, so
// a chroma edge reads 2 samples on each side and writes 1: the edges of one
// direction never touch each other's samples and run in any order; only
// all vertical edges before all horizontal ones matters. So a 4:2:0 thread
// filters one line across both vertical edges and one column across both
// horizontal edges; a 4:2:2 thread one line across both vertical edges and
// one column across two of the four horizontal edges. The block keeps each
// component's MB in a shared tile with the left MB's last 2 columns carried
// along the row; only the 2 rows above come from device memory, after the
// wait. The next MB's lines and its chroma edge parameters are loaded one
// MB ahead. Vertical edges run before the wait; the wait is skipped when
// the MB's chroma top edge has bS = 0, and an MB with bS = 0 on all its
// chroma edges neither waits nor writes.
//
// The C entry points take the caller's stream and report through
// *n_launched how many kernels they launched (1 each).
//
// Data layout: luma planes y [P, H, W], cb/cr [Hc, Wc] (Hc = mb_h * CH_H)
// of T, filtered in place. Edge parameters per 4x4 cell edge, int32 [H4, W4]
// (luma thresholds [P, H4, W4], chroma thresholds [2, H4, W4]), as
// kernels/deblock_prep_dev.py derives them: bs_v/bs_h (and bs_hc for 4:2:2),
// luma indexA/indexB ia_*/ib_*, chroma ca_*/cb_*. tabs = alpha[52], beta[52], tc0[52][3] (Table
// 8-16/8-17), int32. bS must be 0 on the picture's boundary edges (the prep
// guarantees it); the kernels never read outside the picture, except into a
// halo: luma halo T [P, 4, W], chroma halo_cb / halo_cr T [4, Wc] each, or
// null pointers. A halo holds the 4 filtered rows above MB row 0, the bottom
// of the band above in row-band sharding (h264decode_tpu_torch/dist/
// sharded.py), the counterpart of the JAX wavefront's halo argument
// (h264decode_tpu/kernels/deblock.py:118-141). With one, MB row 0 is a row
// like any other: its top edges filter where bS says so, reading the halo as
// the rows above (no wait: no block of the launch writes them before), and
// the rows they modify (3 luma, 1 chroma) are written back into the halo.
// Each entry also takes sync, int32[1 + P * mb_h] of scratch (P = 1 for
// chroma), which it zeroes on the stream before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace {

__device__ __forceinline__ int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// The format's constants: 8-bit samples fold bd_scale and mx at compile time.
template <typename T>
__device__ __forceinline__ int scale_of(int bd_scale) { return sizeof(T) == 1 ? 1 : bd_scale; }
template <typename T>
__device__ __forceinline__ int max_of(int mx) { return sizeof(T) == 1 ? 255 : mx; }

// One luma line across an edge: s points at q0, `step` is the distance
// between taps (1 across a vertical edge, the row pitch across a horizontal
// edge). Spec 8.7.2.3 (bS < 4) and 8.7.2.4 (bS = 4), alpha, beta and tC0
// scaled by sc = 1 << (bd - 8), samples clipped at mx.
template <typename T>
__device__ void filter_luma_line(T* s, int step, int bs, int ia, int ib,
                                 const int* __restrict__ tabs, int sc, int mx) {
  const int alpha = tabs[ia] * sc, beta = tabs[52 + ib] * sc;
  const int p0 = s[-step], p1 = s[-2 * step], p2 = s[-3 * step], p3 = s[-4 * step];
  const int q0 = s[0], q1 = s[step], q2 = s[2 * step], q3 = s[3 * step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta && iabs(q1 - q0) < beta)) return;
  const bool ap = iabs(p2 - p0) < beta, aq = iabs(q2 - q0) < beta;
  if (bs < 4) {
    const int tc0 = tabs[104 + ia * 3 + (bs < 3 ? bs : 3) - 1] * sc;
    const int tc = tc0 + ap + aq;
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[-step] = clip3(0, mx, p0 + delta);
    s[0] = clip3(0, mx, q0 - delta);
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

// One chroma line (ChromaArrayType 1 and 2): tC = tC0 * sc + 1 (bS < 4);
// bS = 4 changes p0/q0 only.
template <typename T>
__device__ void filter_chroma_line(T* s, int step, int bs, int ia, int ib,
                                   const int* __restrict__ tabs, int sc, int mx) {
  const int alpha = tabs[ia] * sc, beta = tabs[52 + ib] * sc;
  const int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta && iabs(q1 - q0) < beta)) return;
  if (bs < 4) {
    const int tc = tabs[104 + ia * 3 + (bs < 3 ? bs : 3) - 1] * sc + 1;
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[-step] = clip3(0, mx, p0 + delta);
    s[0] = clip3(0, mx, q0 - delta);
  } else {
    s[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// 16 bytes of a 4-byte-aligned shared row, as 4 words
__device__ __forceinline__ void put16(void* dst, uint4 v) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

__device__ __forceinline__ uint4 get16(const void* src) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  return make_uint4(s[0], s[1], s[2], s[3]);
}

// Vector moves by the bytes they carry: N samples of T as one register
// type (4 samples: the luma left strip; 2: the chroma left strip; 8: a
// chroma MB line).
template <int BYTES> struct Vec;
template <> struct Vec<2> { using type = uint16_t; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };
template <typename T, int N> using VecOf = typename Vec<N * sizeof(T)>::type;

template <typename T, int N>
__device__ __forceinline__ void copy_n(T* dst, const T* src) {
  *reinterpret_cast<VecOf<T, N>*>(dst) = *reinterpret_cast<const VecOf<T, N>*>(src);
}

// A 16-sample luma line: sizeof(T) 16-byte vectors
template <typename T> struct Line16 { uint4 v[sizeof(T)]; };

template <typename T>
__device__ __forceinline__ Line16<T> load_line16(const T* g) {  // L2-only loads
  Line16<T> l;
#pragma unroll
  for (int k = 0; k < (int)sizeof(T); ++k) l.v[k] = __ldcg(reinterpret_cast<const uint4*>(g) + k);
  return l;
}

template <typename T>
__device__ __forceinline__ void put_line16(T* tile_row, const Line16<T>& l) {
#pragma unroll
  for (int k = 0; k < (int)sizeof(T); ++k) put16(reinterpret_cast<uint8_t*>(tile_row) + 16 * k, l.v[k]);
}

template <typename T>
__device__ __forceinline__ void store_line16(T* g, const T* tile_row) {
#pragma unroll
  for (int k = 0; k < (int)sizeof(T); ++k)
    reinterpret_cast<uint4*>(g)[k] = get16(reinterpret_cast<const uint8_t*>(tile_row) + 16 * k);
}

// Luma: one block of 16 threads per MB row of one of n_planes planes (plane
// p: samples y + p*H*W, thresholds ia_*/ib_* + p*H4*W4, bS shared).
// tile[r][c] holds picture sample
// (16*row - 4 + r, 16*mbx - 4 + c): rows 0..3 the rows above the MB
// (columns 4..19 only), columns 0..3 the left MB's last 4 columns (rows
// 4..19 only), rows/columns 4..19 the MB. prm[k][cell] holds the MB's 16
// cells of bs_v, ia_v, ib_v, bs_h, ia_h, ib_h (cell = 4 * cell row + cell col).
template <typename T>
__global__ void __launch_bounds__(16) deblock_luma_rows(
    T* planes, const int* __restrict__ bs_v, const int* __restrict__ bs_h,
    const int* __restrict__ ia_v, const int* __restrict__ ib_v,
    const int* __restrict__ ia_h, const int* __restrict__ ib_h,
    const int* __restrict__ tabs, T* halo, int* sync, int n_planes, int mb_h, int mb_w,
    int bd_scale, int mx_arg) {
  __shared__ __align__(16) T tile[20][20];
  __shared__ int prm[6][16];
  const int sc = scale_of<T>(bd_scale), mx = max_of<T>(mx_arg);
  const wavefront::RowTicket tk = wavefront::take_row(sync, n_planes);
  const int row = tk.row;
  const int W = 16 * mb_w, W4 = 4 * mb_w;
  T* y = planes + static_cast<size_t>(tk.plane) * (16 * mb_h) * W;
  const int toff = tk.plane * (4 * mb_h) * W4;  // the plane's threshold grids
  int* progress = sync + tk.plane * mb_h;       // the plane's counters
  // the 4 rows above this row: the plane's, or at row 0 the halo's (if any)
  T* hl = halo ? halo + static_cast<size_t>(tk.plane) * 4 * W : nullptr;
  const bool above = row > 0 || hl != nullptr;
  T* up = row > 0 ? y + (16 * row - 4) * W : hl;
  const int t = threadIdx.x;
  const int* grids[6] = {bs_v, ia_v + toff, ib_v + toff, bs_h, ia_h + toff, ib_h + toff};
  const int cell0 = (4 * row + (t >> 2)) * W4 + (t & 3);  // thread t's cell of MB 0
  T* line = y + (16 * row + t) * W;                        // thread t's MB line
  // MB 0, one MB ahead: line t of its samples and cell t of its parameters
  Line16<T> nline = load_line16(line);
  int ncell[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) ncell[k] = __ldg(grids[k] + cell0);
  for (int mbx = 0; mbx < mb_w; ++mbx) {
    put_line16(&tile[4 + t][4], nline);
#pragma unroll
    for (int k = 0; k < 6; ++k) prm[k][t] = ncell[k];
    const bool active = __syncthreads_or(ncell[0] > 0 || ncell[3] > 0);
    if (mbx + 1 < mb_w) {
      nline = load_line16(line + 16 * (mbx + 1));
#pragma unroll
      for (int k = 0; k < 6; ++k) ncell[k] = __ldg(grids[k] + cell0 + 4 * (mbx + 1));
    }
    if (active) {
      // vertical edges, left to right: thread t owns line t. They touch
      // this row's lines only (the tile), so they run before the wait.
      for (int e = 0; e < 4; ++e) {
        const int c = (t >> 2) * 4 + e, bs = prm[0][c];
        if (bs > 0 && (mbx > 0 || e > 0))
          filter_luma_line(&tile[4 + t][4 + 4 * e], 1, bs, prm[1][c], prm[2][c], tabs, sc, mx);
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
      const bool top = above && (prm[3][0] | prm[3][1] | prm[3][2] | prm[3][3]) > 0;
      if (top) {
        wavefront::wait_row(progress, row, min(mbx + 2, mb_w));  // none at row 0
        if (t < 4) put_line16(&tile[t][4], load_line16(up + t * W + 16 * mbx));
      }
      __syncthreads();
      // horizontal edges, top to bottom: thread t owns column t
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * e + (t >> 2), bs = prm[3][c];
        if (bs > 0 && (above || e > 0))
          filter_luma_line(&tile[4 + 4 * e][4 + t], 20, bs, prm[4][c], prm[5][c], tabs, sc, mx);
      }
      __syncthreads();
      // back to the plane: line t with the left strip, rows -3..-1 above
      T* g = line + 16 * mbx;
      if (mbx > 0) copy_n<T, 4>(g - 4, &tile[4 + t][0]);
      store_line16(g, &tile[4 + t][4]);
      if (top && t < 3) store_line16(up + (1 + t) * W + 16 * mbx, &tile[1 + t][4]);
    }
    // the MB's last 4 columns are the next MB's left strip (own line only)
    copy_n<T, 4>(&tile[4 + t][0], &tile[4 + t][16]);
    wavefront::publish_row(progress, row, mbx + 1);
  }
}

// Chroma: one block of 2 * CH_H threads per MB row; thread t of component
// c = threadIdx.x / CH_H (0 Cb, 1 Cr), t = threadIdx.x % CH_H, filters line
// t across the two vertical edges and column t & 7 across the horizontal
// edges hedge(t, 0) and hedge(t, 1): luma edges 0 and 2 for 4:2:0, luma
// cell rows 2 * (t >> 3) and 2 * (t >> 3) + 1 for 4:2:2, each at chroma row
// (CH_H / 4) * edge. tile[c][r][k] holds picture sample
// (CH_H*row - 2 + r, 8*mbx - 8 + k) of component c: rows 0..1 the rows above
// the MB (columns 8..15 only), columns 6..7 the left MB's last 2 columns
// (rows 2..CH_H+1 only), rows 2..CH_H+1 / columns 8..15 the MB, aligned to
// one 8-sample line. Thread t's parameters are the cells of its line (bs_v
// at cell row t / (CH_H / 4), cell columns 0 and 2) and of its column (bs_h
// or bs_hc at its two edges' cell rows, cell column (t & 7) / 2), with its
// component's indexA / indexB. For 4:2:0, bS on luma edges 1 and 3 alone
// gives the MB no chroma work.
template <int CH_H>
__device__ __forceinline__ int hedge(int t, int ei) {
  return CH_H == 8 ? 2 * ei : 2 * (t >> 3) + ei;
}

template <typename T, int CH_H>
__global__ void __launch_bounds__(2 * CH_H) deblock_chroma_rows(
    T* cb, T* cr, const int* __restrict__ bs_v, const int* __restrict__ bs_hc,
    const int* __restrict__ ca_v, const int* __restrict__ cb_v,
    const int* __restrict__ ca_h, const int* __restrict__ cb_h,
    const int* __restrict__ tabs, T* halo_cb, T* halo_cr, int* sync, int mb_h, int mb_w,
    int bd_scale, int mx_arg) {
  constexpr int RV = CH_H / 4;  // chroma lines per luma cell row
  __shared__ __align__(16) T tile[2][2 + CH_H][16];
  const int sc = scale_of<T>(bd_scale), mx = max_of<T>(mx_arg);
  const int row = wavefront::take_row(sync, 1).row;
  const int Wc = 8 * mb_w, W4 = 4 * mb_w, H4 = 4 * mb_h;
  const int c = threadIdx.x / CH_H, t = threadIdx.x % CH_H, col = t & 7;
  T (*tl)[16] = tile[c];
  T* pl = c ? cr : cb;
  // the 2 rows above this row that the top edge reads: the plane's, or at
  // row 0 the last 2 of the component's halo (if any)
  T* hl = c ? halo_cr : halo_cb;
  const bool above = row > 0 || hl != nullptr;
  T* up = row > 0 ? pl + (CH_H * row - 2) * Wc : (hl ? hl + 2 * Wc : nullptr);
  const int coff = c * H4 * W4;  // component plane of the [2, H4, W4] grids
  const int vcell = (4 * row + t / RV) * W4;     // + 4*mbx + 2*ei: line t's cells
  const int hcell = 4 * row * W4 + (col >> 1);   // + hedge*W4 + 4*mbx: column's
  T* line = pl + (CH_H * row + t) * Wc;          // thread t's MB line
  // MB 0, one MB ahead: line t of its samples, the bS / indexA / indexB of
  // its line's two vertical and its column's two horizontal chroma edges
  VecOf<T, 8> nline = __ldcg(reinterpret_cast<const VecOf<T, 8>*>(line));
  int nv[3][2], nh[3][2];
  auto fetch = [&](int mbx) {
#pragma unroll
    for (int ei = 0; ei < 2; ++ei) {
      const int v = vcell + 4 * mbx + 2 * ei, h = hcell + hedge<CH_H>(t, ei) * W4 + 4 * mbx;
      nv[0][ei] = __ldg(bs_v + v);
      nv[1][ei] = __ldg(ca_v + coff + v);
      nv[2][ei] = __ldg(cb_v + coff + v);
      nh[0][ei] = __ldg(bs_hc + h);
      nh[1][ei] = __ldg(ca_h + coff + h);
      nh[2][ei] = __ldg(cb_h + coff + h);
    }
  };
  fetch(0);
  for (int mbx = 0; mbx < mb_w; ++mbx) {
    *reinterpret_cast<VecOf<T, 8>*>(&tl[2 + t][8]) = nline;
    int pv[3][2], ph[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int ei = 0; ei < 2; ++ei) { pv[k][ei] = nv[k][ei]; ph[k][ei] = nh[k][ei]; }
    const bool active = __syncthreads_or((pv[0][0] | pv[0][1] | ph[0][0] | ph[0][1]) > 0);
    if (mbx + 1 < mb_w) {
      nline = __ldcg(reinterpret_cast<const VecOf<T, 8>*>(line + 8 * (mbx + 1)));
      fetch(mbx + 1);
    }
    if (active) {
      // vertical edges, left to right: thread t owns line t of its
      // component. They touch this row's lines only, so they run before
      // the wait.
#pragma unroll
      for (int ei = 0; ei < 2; ++ei)
        if (pv[0][ei] > 0 && (mbx > 0 || ei > 0))
          filter_chroma_line(&tl[2 + t][8 + 4 * ei], 1, pv[0][ei], pv[1][ei], pv[2][ei], tabs,
                             sc, mx);
      // Why the vertical edges may run before the wait, and an MB whose
      // chroma top edge has bS = 0 may skip it. In chroma samples, with
      // L = CH_H lines per MB row (8 for 4:2:0, 16 for 4:2:2), MB (x, row)
      // reads lines L*row-2 .. L*row+L-1 of columns 8x-2 .. 8x+7 and writes
      // lines L*row-1 .. L*row+L-1 of columns 8x-1 .. 8x+7; only its top
      // edge (chroma row 0) reads or writes lines of row-1: the 4:2:2 edges
      // at chroma rows 4, 8 and 12 read rows 2 .. 13 and write rows 3 .. 12
      // of this MB, inside its own lines. No block of row-1 ever reads or
      // writes a line of this row. Row+1's MB x' writes line L*row+L-1 of
      // columns 8x' .. 8x'+7 (and reads lines L*row+L-2, L*row+L-1 there)
      // only after this row has published x'+2 MBs, so nothing but this
      // block has written columns 8x-2 .. 8x+7 of this row's lines when it
      // loads them (one MB ahead) or filters them. Row-1's lines under MB x
      // are final only once row-1 has finished MB x+1, whose left-edge
      // filter rewrites column 8x+7 of lines L*row-L .. L*row-1: hence
      // need = x+2, before the top edge alone. For 4:2:2 that argument is
      // the 4:2:0 one with 16 lines in place of 8; the chain stays 254 steps.
      const bool top = __syncthreads_or(above && hedge<CH_H>(t, 0) == 0 && ph[0][0] > 0);
      if (top) {
        wavefront::wait_row(sync, row, min(mbx + 2, mb_w));  // none at row 0
        if (t < 2)
          *reinterpret_cast<VecOf<T, 8>*>(&tl[t][8]) =
              __ldcg(reinterpret_cast<const VecOf<T, 8>*>(up + t * Wc + 8 * mbx));
      }
      __syncthreads();
      // horizontal edges: thread t owns column t & 7 at its two edges
#pragma unroll
      for (int ei = 0; ei < 2; ++ei) {
        const int e = hedge<CH_H>(t, ei);
        if (ph[0][ei] > 0 && (above || e > 0))
          filter_chroma_line(&tl[2 + RV * e][8 + col], 16, ph[0][ei], ph[1][ei], ph[2][ei], tabs,
                             sc, mx);
      }
      __syncthreads();
      // Back to the plane, nothing deferred: line t with the left MB's last
      // column (the left edge's p0), and the line above (the top edge's p0).
      // So when this row publishes n, MBs 0..n-1 are in the plane, each but
      // MB n-1 with the column its right neighbour's left edge rewrote;
      // need = x+2 above waits for exactly that.
      T* g = line + 8 * mbx;
      if (mbx > 0) g[-1] = tl[2 + t][7];
      copy_n<T, 8>(g, &tl[2 + t][8]);
      if (top && t == 0) copy_n<T, 8>(up + Wc + 8 * mbx, &tl[1][8]);
    }
    // the MB's last 2 columns are the next MB's left strip (own line only)
    copy_n<T, 2>(&tl[2 + t][6], &tl[2 + t][14]);
    wavefront::publish_row(sync, row, mbx + 1);
  }
}

}  // namespace

// planes: the number of [H, W] planes in y and of [H4, W4] grids in ia_* /
// ib_* (1, or 3 for 4:4:4); sample_bytes: 1 (uint8_t samples, 8-bit) or 2
// (uint16_t, 9 to 14 bits); bd_scale = 1 << (bd - 8) and mx = (1 << bd) - 1
// (read for 2-byte samples); halo: the [planes, 4, W] rows above MB row 0,
// read and written back, or null
extern "C" int deblock_luma(void* y, const void* bs_v, const void* bs_h, const void* ia_v,
                            const void* ib_v, const void* ia_h, const void* ib_h,
                            const void* tabs, void* halo, void* sync, int planes, int mb_h,
                            int mb_w, int sample_bytes, int bd_scale, int mx, void* stream,
                            int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  if ((sample_bytes != 1 && sample_bytes != 2) || planes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + planes * mb_h), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int *pv = static_cast<const int*>(bs_v), *ph = static_cast<const int*>(bs_h);
  const int *av = static_cast<const int*>(ia_v), *bv = static_cast<const int*>(ib_v);
  const int *ah = static_cast<const int*>(ia_h), *bh = static_cast<const int*>(ib_h);
  const int* tb = static_cast<const int*>(tabs);
  int* ps = static_cast<int*>(sync);
  const int blocks = planes * mb_h;
  if (sample_bytes == 1)
    deblock_luma_rows<uint8_t><<<blocks, 16, 0, s>>>(static_cast<uint8_t*>(y), pv, ph, av, bv,
                                                     ah, bh, tb, static_cast<uint8_t*>(halo),
                                                     ps, planes, mb_h, mb_w, bd_scale, mx);
  else
    deblock_luma_rows<uint16_t><<<blocks, 16, 0, s>>>(static_cast<uint16_t*>(y), pv, ph, av,
                                                      bv, ah, bh, tb,
                                                      static_cast<uint16_t*>(halo), ps, planes,
                                                      mb_h, mb_w, bd_scale, mx);
  *n_launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// ch_h: chroma MB height, 8 (4:2:0) or 16 (4:2:2); bs_hc: the horizontal
// chroma bS grid (bs_h for 4:2:0, the prep's bs_hc for 4:2:2); halo_cb /
// halo_cr: the [4, Wc] rows above MB row 0, read and written back, or null
extern "C" int deblock_chroma(void* cb, void* cr, const void* bs_v, const void* bs_hc,
                              const void* ca_v, const void* cb_v, const void* ca_h,
                              const void* cb_h, const void* tabs, void* halo_cb,
                              void* halo_cr, void* sync, int mb_h, int mb_w, int ch_h,
                              int sample_bytes, int bd_scale, int mx, void* stream,
                              int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  if ((sample_bytes != 1 && sample_bytes != 2) || (ch_h != 8 && ch_h != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (mb_h + 1), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int *pv = static_cast<const int*>(bs_v), *ph = static_cast<const int*>(bs_hc);
  const int *av = static_cast<const int*>(ca_v), *bv = static_cast<const int*>(cb_v);
  const int *ah = static_cast<const int*>(ca_h), *bh = static_cast<const int*>(cb_h);
  const int* tb = static_cast<const int*>(tabs);
  int* ps = static_cast<int*>(sync);
  if (sample_bytes == 1) {
    uint8_t *b = static_cast<uint8_t*>(cb), *r = static_cast<uint8_t*>(cr);
    uint8_t *hb = static_cast<uint8_t*>(halo_cb), *hr = static_cast<uint8_t*>(halo_cr);
    if (ch_h == 8)
      deblock_chroma_rows<uint8_t, 8><<<mb_h, 16, 0, s>>>(b, r, pv, ph, av, bv, ah, bh, tb, hb,
                                                          hr, ps, mb_h, mb_w, bd_scale, mx);
    else
      deblock_chroma_rows<uint8_t, 16><<<mb_h, 32, 0, s>>>(b, r, pv, ph, av, bv, ah, bh, tb, hb,
                                                           hr, ps, mb_h, mb_w, bd_scale, mx);
  } else {
    uint16_t *b = static_cast<uint16_t*>(cb), *r = static_cast<uint16_t*>(cr);
    uint16_t *hb = static_cast<uint16_t*>(halo_cb), *hr = static_cast<uint16_t*>(halo_cr);
    if (ch_h == 8)
      deblock_chroma_rows<uint16_t, 8><<<mb_h, 16, 0, s>>>(b, r, pv, ph, av, bv, ah, bh, tb, hb,
                                                           hr, ps, mb_h, mb_w, bd_scale, mx);
    else
      deblock_chroma_rows<uint16_t, 16><<<mb_h, 32, 0, s>>>(b, r, pv, ph, av, bv, ah, bh, tb, hb,
                                                            hr, ps, mb_h, mb_w, bd_scale, mx);
  }
  *n_launched = 1;
  return static_cast<int>(cudaGetLastError());
}
