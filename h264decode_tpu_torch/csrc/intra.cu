// Intra prediction + reconstruction (H.264 spec 8.3) for Hopper: 4:2:0 and
// 4:2:2 (ChromaArrayType 1 and 2, also 0 = monochrome run as 4:2:0), bit
// depths 8 to 14, and 8-bit 4:4:4 (ChromaArrayType 3), whose Cb and Cr
// planes take the luma process (8.3.4.5) in the luma kernel's launch.
//
// Replaces the Pallas TPU kernels of h264decode_tpu/kernels/intra_pallas.py:
//   intra_luma   <- _make_luma_kernel   (intra_pallas.py:440)
//   intra_chroma <- _make_chroma_kernel (intra_pallas.py:590)
// called from intra_frame_pallas (intra_pallas.py:645). Those are 4:2:0
// 8-bit only; the JAX package runs 4:2:2 and high bit depths through the
// XLA wavefront intra_wavefront(ch_h, mid, mx) (kernels/intra.py:391). The
// plain version this file is held against is
// h264decode_tpu_torch/kernels/intra.py, which covers every format. For
// 4:4:4 the JAX package calls intra_frame_pallas once per plane with dummy
// chroma (tpu_pipeline.py:447-459); here intra_luma runs the three planes in
// one launch and the chroma kernel does not run.
//
// The format enters as arguments: the Clip1 ceiling mx = (1 << bd) - 1 and
// the DC fallback mid = 1 << (bd - 1) for both kernels, and the chroma MB
// height CH_H (8 or 16) as a template parameter of the chroma kernel. The
// 8-bit instantiations (BD8) fold mid and mx to the constants 128 and 255.
//
// What bounds it on this card: the spec makes each luma macroblock depend
// on its reconstructed left, top, top-right and top-left neighbours, so
// luma is a serial chain of mb_w + 2*(mb_h - 1) MB steps (254 at 1080p):
// MB (x, y) can start once row y-1 has finished MB x+1. Chroma has no
// top-right neighbour (8.3.4): its chain is mb_w + mb_h - 1 steps (187 at
// 1080p), MB (x, y) starting once row y-1 has finished MB x. The bytes are
// small (one read of the planes, residual and per-MB parameters, one write
// of the planes: a few microseconds at 3.35 TB/s), so the time of one step
// of the chain (the hand-off between rows plus one MB's own latency) times
// the chain's length bounds it, not bandwidth.
//
// Luma design (intra_luma_rows): one persistent launch per call, one block
// of 256 threads per MB row of each of P planes (P = 1, or 3 for 4:4:4,
// whose planes share the MB modes and availability, 8.3.4.5), rows handed on
// through each plane's progress counters in device memory (wavefront.cuh).
// The planes' chains are independent and run side by side: at 256 threads
// and 64 registers a thread, 4 blocks fit on an SM, so the 3 x 68 blocks of
// a 1080p 4:4:4 frame are all resident on the H100's 132 SMs. The block keeps the reconstructed right
// column of its last MB in shared memory as the next MB's left column; only
// the 25 samples of the row above (columns -1..23) come from device memory,
// after the wait. The next MB's parameter row and 16x16 residual depend on
// no other block and are loaded into registers before the wait, so they
// overlap it. Intra4x4 / Intra8x8 walk their sub-blocks in z-order with
// __syncthreads() between them. A non-intra MB only publishes its progress
// (its pixels keep their inter/PCM values), the counterpart of the Pallas
// kernels' skip of blocks without intra MBs.
//
// Chroma design (intra_chroma_rows<CH_H>): the same row wavefront, one block
// of 16 * CH_H threads per MB row (8 * CH_H per component, one per sample:
// 128 threads for 4:2:0, 256 for 4:2:2), waiting for row y-1 to finish MB x
// only. The block carries the reconstructed right column (CH_H samples) of
// an intra MB in shared memory as the next MB's left column (a non-intra
// left MB's column is read from the plane, which no block writes); only the
// corner and the 8 samples above come from device memory after the wait.
// The next MB's residual and parameters are loaded before the wait; a
// non-intra MB only publishes.
//
// The C entry points take the caller's stream and report through
// *n_launched how many kernels they launched (1 each).
//
// Data layout (all int32, contiguous): luma planes y [P, H, W], cb/cr
// [Hc, Wc] (Hc = mb_h * CH_H), updated in place; residual planes of the same
// shapes;
// params [nMB, 20] = kind, i16mode, cmode, avail bits (1 left, 2 top,
// 4 top-right, 8 top-left), modes4[16] (z-order; 8x8 modes in the first 4).
// Samples outside the picture read as 0, as in the plain version, except
// the row above MB row 0 where the caller gives it: top (luma, int32
// [P, W]) and top_cb / top_cr (int32 [Wc] each), or null pointers. That is
// the halo input of row-band sharding (h264decode_tpu_torch/dist/sharded.py):
// a band's MB row 0 predicts from the unfiltered bottom row of the band
// above, the counterpart of the JAX wavefront's top argument
// (h264decode_tpu/kernels/intra.py:401). No block writes it, so it is read
// at row 0 like any row above, with no wait (columns -1 and W.. read as 0).
// Each entry also takes sync, int32[1 + P * mb_h] of scratch (P = 1 for
// chroma), which it zeroes on the stream before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace {

constexpr int NPARAM = 20;
constexpr int K_I4 = 1, K_I8 = 2, K_I16 = 3;
constexpr int AV_L = 1, AV_T = 2, AV_TR = 4, AV_TL = 8;

// z-order sub-block positions (spec 6.4.3) and whether the block's
// top-right neighbour inside the MB is decoded before it
__constant__ int kBX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int kBY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int kTR[16] = {0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0};

// Clip1 at the stream's bit depth: [0, mx]
__device__ __forceinline__ int clip1(int v, int mx) { return v < 0 ? 0 : (v > mx ? mx : v); }

// DC from both neighbours, the top, the left, or mid = 1 << (bd - 1)
__device__ __forceinline__ int dc3(bool hl, bool ht, int both, int only_t, int only_l, int mid) {
  return (hl && ht) ? both : (ht ? only_t : (hl ? only_l : mid));
}

// spec 8.3.1.2 / 8.3.2.2 prediction of sample (x, y) of an N x N block
// (N = 4 or 8) from its top row t[0..2N-1] (substituted), left column
// l[0..N-1] and corner m; T(-1) = L(-1) = m.
template <int N>
__device__ int pred_nxn(int mode, int x, int y, const int* t, const int* l, int m, int dc) {
  auto T = [&](int i) { return i < 0 ? m : t[i]; };
  auto L = [&](int j) { return j < 0 ? m : l[j]; };
  switch (mode) {
    case 0: return T(x);
    case 1: return L(y);
    case 2: return dc;
    case 3:  // diagonal down left
      if (x == N - 1 && y == N - 1) return (T(2 * N - 2) + 3 * T(2 * N - 1) + 2) >> 2;
      return (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
    case 4:  // diagonal down right
      if (x > y) return (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
      if (x < y) return (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
      return (T(0) + 2 * m + L(0) + 2) >> 2;
    case 5: {  // vertical right
      int z = 2 * x - y, k = x - (y >> 1);
      if (z >= 0 && (z & 1) == 0) return (T(k - 1) + T(k) + 1) >> 1;
      if (z >= 0) return (T(k - 2) + 2 * T(k - 1) + T(k) + 2) >> 2;
      if (z == -1) return (L(0) + 2 * m + T(0) + 2) >> 2;
      return (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
    }
    case 6: {  // horizontal down
      int z = 2 * y - x, k = y - (x >> 1);
      if (z >= 0 && (z & 1) == 0) return (L(k - 1) + L(k) + 1) >> 1;
      if (z >= 0) return (L(k - 2) + 2 * L(k - 1) + L(k) + 2) >> 2;
      if (z == -1) return (L(0) + 2 * m + T(0) + 2) >> 2;
      return (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
    }
    case 7: {  // vertical left
      int k = x + (y >> 1);
      if ((y & 1) == 0) return (T(k) + T(k + 1) + 1) >> 1;
      return (T(k) + 2 * T(k + 1) + T(k + 2) + 2) >> 2;
    }
    default: {  // 8: horizontal up
      int z = x + 2 * y, k = y + (x >> 1);
      if (z > 2 * N - 3) return L(N - 1);
      if (z == 2 * N - 3) return (L(N - 2) + 3 * L(N - 1) + 2) >> 2;
      if ((z & 1) == 0) return (L(k) + L(k + 1) + 1) >> 1;
      return (L(k) + 2 * L(k + 1) + L(k + 2) + 2) >> 2;
    }
  }
}

// Luma: one block of 256 threads per MB row of one of n_planes planes
// (planes and residuals [n_planes, H, W], one params table for all); thread
// tid covers sample
// (tid >> 4, tid & 15) of the MB. sm[r][c] holds picture sample
// (16*row - 1 + r, 16*mbx - 1 + c): row 0 is the row above (columns -1..23,
// reaching into the top-right MB), column 0 the column to the left; rows
// 1..16, columns 1..16 the MB itself. rs is the MB's residual, sp its
// parameter row.
template <bool BD8>
__global__ void __launch_bounds__(256) intra_luma_rows(
    int* planes, const int* __restrict__ resid, const int* __restrict__ prm,
    const int* __restrict__ top, int* sync, int n_planes, int mb_h, int mb_w, int mid_arg,
    int mx_arg) {
  const int mid = BD8 ? 128 : mid_arg, mx = BD8 ? 255 : mx_arg;
  __shared__ int sm[17][25];
  __shared__ int rs[16][16];
  __shared__ int sp[NPARAM];
  const wavefront::RowTicket tk = wavefront::take_row(sync, n_planes);
  const int row = tk.row;
  const int W = mb_w * 16;
  const size_t plane_off = static_cast<size_t>(tk.plane) * (16 * mb_h) * W;
  int* y = planes + plane_off;
  const int* res = resid + plane_off;
  int* progress = sync + tk.plane * mb_h;  // this plane's counters
  const int* top_row = top ? top + static_cast<size_t>(tk.plane) * W : nullptr;
  const int tid = threadIdx.x, px = tid & 15, py = tid >> 4;
  const int* res_row = res + (16 * row + py) * W + px;
  const int* prm_row = prm + row * mb_w * NPARAM;
  // the next MB's residual sample and parameter (no block writes them)
  int nres = __ldg(res_row), nprm = tid < NPARAM ? __ldg(prm_row + tid) : 0;
  bool have_left = false;  // sm[1..16][0] holds the left MB's final column
  for (int mbx = 0; mbx < mb_w; ++mbx) {
    rs[py][px] = nres;
    if (tid < NPARAM) sp[tid] = nprm;
    __syncthreads();
    if (mbx + 1 < mb_w) {
      nres = __ldg(res_row + 16 * (mbx + 1));
      if (tid < NPARAM) nprm = __ldg(prm_row + (mbx + 1) * NPARAM + tid);
    }
    const int kind = sp[0];
    if (kind != K_I4 && kind != K_I8 && kind != K_I16) {
      have_left = false;  // this MB's samples stay as they are in y
      wavefront::publish_row(progress, row, mbx + 1);
      continue;
    }
    if (!have_left && tid < 16)  // left MB not intra: its samples are final in y
      sm[1 + tid][0] = mbx > 0 ? __ldcg(y + (16 * row + tid) * W + 16 * mbx - 1) : 0;
    wavefront::wait_row(progress, row, min(mbx + 2, mb_w));
    if (tid < 25) {
      const int gc = 16 * mbx - 1 + tid;
      sm[0][tid] = (gc < 0 || gc >= W) ? 0
                   : row > 0 ? __ldcg(y + (16 * row - 1) * W + gc)
                   : top_row ? __ldg(top_row + gc) : 0;
    }
    __syncthreads();
    const int av = sp[3];
    const bool avl = av & AV_L, avt = av & AV_T, avtr = av & AV_TR, avtl = av & AV_TL;

    if (kind == K_I16) {
      const int m = sm[0][0];
      int st = 0, sl = 0, hs = 0, vs = 0;
      for (int i = 0; i < 16; ++i) { st += sm[0][1 + i]; sl += sm[1 + i][0]; }
      for (int k = 0; k < 8; ++k) {
        int ta = sm[0][9 + k], tb = (k == 7) ? m : sm[0][7 - k];
        int la = sm[9 + k][0], lb = (k == 7) ? m : sm[7 - k][0];
        hs += (k + 1) * (ta - tb);
        vs += (k + 1) * (la - lb);
      }
      const int mode = min(max(sp[1], 0), 3);
      int pred;
      if (mode == 0) pred = sm[0][1 + px];
      else if (mode == 1) pred = sm[1 + py][0];
      else if (mode == 2)
        pred = dc3(avl, avt, (st + sl + 16) >> 5, (st + 8) >> 4, (sl + 8) >> 4, mid);
      else {
        int a = 16 * (sm[16][0] + sm[0][16]);
        int b = (5 * hs + 32) >> 6, c = (5 * vs + 32) >> 6;
        pred = clip1((a + b * (px - 7) + c * (py - 7) + 16) >> 5, mx);
      }
      // reads touch row 0 and column 0 only, writes the interior: no hazard
      sm[1 + py][1 + px] = clip1(pred + rs[py][px], mx);
      __syncthreads();
    } else if (kind == K_I4) {
      for (int k = 0; k < 16; ++k) {
        const int bx = kBX[k], by = kBY[k];
        if (tid < 16) {
          const int x = tid & 3, yy = tid >> 2;
          const int R = 4 * by, C = 4 * bx;  // sm row of the row above, sm col of the left column
          int t[8], l[4];
          for (int i = 0; i < 8; ++i) t[i] = sm[R][C + 1 + i];
          for (int j = 0; j < 4; ++j) l[j] = sm[R + 1 + j][C];
          const int m = sm[R][C];
          const bool hl = bx > 0 || avl, ht = by > 0 || avt;
          const bool htr = by > 0 ? (kTR[k] != 0) : (bx < 3 ? avt : avtr);
          if (!htr) for (int i = 4; i < 8; ++i) t[i] = t[3];
          int st = t[0] + t[1] + t[2] + t[3], sl = l[0] + l[1] + l[2] + l[3];
          int dc = dc3(hl, ht, (st + sl + 4) >> 3, (st + 2) >> 2, (sl + 2) >> 2, mid);
          int mode = min(max(sp[4 + k], 0), 8);
          int pred = pred_nxn<4>(mode, x, yy, t, l, m, dc);
          sm[R + 1 + yy][C + 1 + x] = clip1(pred + rs[4 * by + yy][4 * bx + x], mx);
        }
        __syncthreads();
      }
    } else {  // K_I8
      for (int b8 = 0; b8 < 4; ++b8) {
        const int bx8 = b8 & 1, by8 = b8 >> 1;
        if (tid < 64) {
          const int x = tid & 7, yy = tid >> 3;
          const int R = 8 * by8, C = 8 * bx8;
          int t[16], l[8];
          for (int i = 0; i < 16; ++i) t[i] = sm[R][C + 1 + i];
          for (int j = 0; j < 8; ++j) l[j] = sm[R + 1 + j][C];
          const int m = sm[R][C];
          const bool hl = bx8 > 0 || avl, ht = by8 > 0 || avt;
          const bool htr = by8 == 0 ? (bx8 == 0 ? avt : avtr) : (bx8 == 0);
          const bool hc = b8 == 0 ? avtl : (b8 == 1 ? avt : (b8 == 2 ? avl : true));
          if (!htr) for (int i = 8; i < 16; ++i) t[i] = t[7];
          // 8.3.2.2.1 reference sample filtering
          const int tl = hc ? m : 0;
          int ft[16], fl[8];
          ft[0] = hc ? (tl + 2 * t[0] + t[1] + 2) >> 2 : (3 * t[0] + t[1] + 2) >> 2;
          for (int i = 1; i < 15; ++i) ft[i] = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2;
          ft[15] = (t[14] + 3 * t[15] + 2) >> 2;
          fl[0] = hc ? (tl + 2 * l[0] + l[1] + 2) >> 2 : (3 * l[0] + l[1] + 2) >> 2;
          for (int j = 1; j < 7; ++j) fl[j] = (l[j - 1] + 2 * l[j] + l[j + 1] + 2) >> 2;
          fl[7] = (l[6] + 3 * l[7] + 2) >> 2;
          const int fm = (hl && ht) ? (t[0] + 2 * m + l[0] + 2) >> 2
                       : ht ? (3 * m + t[0] + 2) >> 2
                       : hl ? (3 * m + l[0] + 2) >> 2 : m;
          int st = 0, sl = 0;
          for (int i = 0; i < 8; ++i) { st += ft[i]; sl += fl[i]; }
          int dc = dc3(hl, ht, (st + sl + 8) >> 4, (st + 4) >> 3, (sl + 4) >> 3, mid);
          int mode = min(max(sp[4 + b8], 0), 8);
          int pred = pred_nxn<8>(mode, x, yy, ft, fl, fm, dc);
          sm[R + 1 + yy][C + 1 + x] = clip1(pred + rs[8 * by8 + yy][8 * bx8 + x], mx);
        }
        __syncthreads();
      }
    }
    y[(16 * row + py) * W + 16 * mbx + px] = sm[1 + py][1 + px];
    if (tid < 16) sm[1 + tid][0] = sm[1 + tid][16];  // right column -> next MB's left
    have_left = true;
    wavefront::publish_row(progress, row, mbx + 1);
  }
}

// Chroma: one block of 16 * CH_H threads per MB row; thread tid covers
// sample (yy, x) = ((tid >> 3) % CH_H, tid & 7) of component tid / (8 * CH_H)
// (0 Cb, 1 Cr). top[c][i] holds picture sample (CH_H*row - 1, 8*mbx - 1 + i)
// (at row 0, from top_cb / top_cr when given):
// the corner and the 8 samples above. left[mbx & 1][c] holds the CH_H
// samples to the left (double-buffered by MB parity, so the MB's right
// column can be stored for the next MB while other threads still read this
// MB's left column).
template <int CH_H, bool BD8>
__global__ void __launch_bounds__(16 * CH_H) intra_chroma_rows(
    int* cb, int* cr, const int* __restrict__ rcb, const int* __restrict__ rcr,
    const int* __restrict__ prm, const int* __restrict__ top_cb, const int* __restrict__ top_cr,
    int* sync, int mb_h, int mb_w, int mid_arg, int mx_arg) {
  const int mid = BD8 ? 128 : mid_arg, mx = BD8 ? 255 : mx_arg;
  constexpr int NC = 8 * CH_H;  // samples (threads) per component
  constexpr int YC = CH_H / 2;  // plane-mode centre row offset: 4 (4:2:0), 8 (4:2:2)
  __shared__ int top[2][9];
  __shared__ int left[2][2][CH_H];
  const int row = wavefront::take_row(sync, 1).row;
  const int Wc = mb_w * 8;
  const int c = threadIdx.x / NC, i = threadIdx.x % NC, x = i & 7, yy = i >> 3;
  int* pl = c ? cr : cb;
  const int* tp = c ? top_cr : top_cb;  // the row above MB row 0, or null
  const int* res = (c ? rcr : rcb) + (CH_H * row + yy) * Wc + x;
  const int* prm_row = prm + row * mb_w * NPARAM;
  // the next MB's residual sample and its kind / cmode / avail (no block
  // writes them)
  int nres = __ldg(res), nkind = __ldg(prm_row), ncm = __ldg(prm_row + 2),
      nav = __ldg(prm_row + 3);
  bool have_left = false;  // left[mbx & 1] holds the left MB's final column
  for (int mbx = 0; mbx < mb_w; ++mbx) {
    const int kind = nkind, cm = ncm, av = nav, rs = nres;
    if (mbx + 1 < mb_w) {
      const int* p = prm_row + (mbx + 1) * NPARAM;
      nres = __ldg(res + 8 * (mbx + 1));
      nkind = __ldg(p);
      ncm = __ldg(p + 2);
      nav = __ldg(p + 3);
    }
    if (kind == 0) {  // not intra (chroma runs for every intra kind)
      have_left = false;  // this MB's samples stay as they are in the plane
      wavefront::publish_row(sync, row, mbx + 1);
      continue;
    }
    const int r0 = CH_H * row, c0 = 8 * mbx;
    int* l = left[mbx & 1][c];
    if (!have_left && i < CH_H)  // left MB not intra: its samples are final in the plane
      l[i] = mbx > 0 ? __ldcg(pl + (r0 + i) * Wc + c0 - 1) : 0;
    // Chroma prediction (spec 8.3.4) reads only the CH_H samples to the
    // left, the 8 above and the corner above-left, never the MB above-right,
    // in 4:2:0 and 4:2:2 alike: MB (x, row) depends on (x-1, row),
    // (x, row-1) and (x-1, row-1) alone. So it waits until row-1 has
    // finished MB x (need = x+1, not luma's x+2), and the chain is
    // mb_w + mb_h - 1 MB steps (187 at 1080p).
    wavefront::wait_row(sync, row, mbx + 1);
    if (i < 9) {  // samples outside the picture read as 0
      const int gc = c0 - 1 + i;
      top[c][i] = gc < 0 ? 0 : row > 0 ? __ldcg(pl + (r0 - 1) * Wc + gc) : tp ? __ldg(tp + gc) : 0;
    }
    __syncthreads();
    const bool avl = av & AV_L, avt = av & AV_T;
    const int* t = &top[c][1];  // t[-1] is the corner
    const int m = t[-1];
    const int mode = min(max(cm, 0), 3);
    int pred;
    if (mode == 0) {  // DC per 4x4 block (8.3.4.1-3)
      const int qx = x >> 2, qy = yy >> 2;
      int st = 0, sl = 0;
      for (int k = 0; k < 4; ++k) { st += t[4 * qx + k]; sl += l[4 * qy + k]; }
      const int both = (st + sl + 4) >> 3, ot = (st + 2) >> 2, ol = (sl + 2) >> 2;
      // the corner block and the blocks off both edges use both sides; the
      // rest of the top row prefers the top, the rest of the left column
      // the left
      if ((qx == 0) == (qy == 0)) pred = dc3(avl, avt, both, ot, ol, mid);
      else if (qx == 1) pred = avt ? ot : (avl ? ol : mid);
      else pred = avl ? ol : (avt ? ot : mid);
    } else if (mode == 1) {
      pred = l[yy];
    } else if (mode == 2) {
      pred = t[x];
    } else {  // plane (8.3.4.4): xCF = 0, yCF = 0 (4:2:0) or 4 (4:2:2)
      int hs = 0, vs = 0;
      for (int k = 0; k < 4; ++k) hs += (k + 1) * (t[4 + k] - (k == 3 ? m : t[2 - k]));
      for (int k = 0; k < YC; ++k) vs += (k + 1) * (l[YC + k] - (k == YC - 1 ? m : l[YC - 2 - k]));
      int a = 16 * (l[CH_H - 1] + t[7]);
      int b = (34 * hs + 32) >> 6, cc = ((CH_H == 8 ? 34 : 5) * vs + 32) >> 6;
      pred = clip1((a + b * (x - 3) + cc * (yy - (YC - 1)) + 16) >> 5, mx);
    }
    const int v = clip1(pred + rs, mx);
    pl[(r0 + yy) * Wc + c0 + x] = v;
    if (x == 7) left[(mbx + 1) & 1][c][yy] = v;  // right column -> next MB's left
    have_left = true;
    wavefront::publish_row(sync, row, mbx + 1);
  }
}

}  // namespace

// planes: the number of [H, W] planes in y and res (1, or 3 for 4:4:4);
// top: the [planes, W] row above MB row 0, or null
extern "C" int intra_luma(void* y, const void* res, const void* params, const void* top,
                          void* sync, int planes, int mb_h, int mb_w, int mid, int mx,
                          void* stream, int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  if (planes < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + planes * mb_h), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* py = static_cast<int*>(y);
  const int *pr = static_cast<const int*>(res), *prm = static_cast<const int*>(params);
  const int* pt = static_cast<const int*>(top);
  int* ps = static_cast<int*>(sync);
  const int blocks = planes * mb_h;
  if (mx == 255)
    intra_luma_rows<true><<<blocks, 256, 0, s>>>(py, pr, prm, pt, ps, planes, mb_h, mb_w, mid, mx);
  else
    intra_luma_rows<false><<<blocks, 256, 0, s>>>(py, pr, prm, pt, ps, planes, mb_h, mb_w, mid, mx);
  *n_launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// ch_h: chroma MB height, 8 (4:2:0) or 16 (4:2:2); top_cb / top_cr: the [Wc]
// rows above MB row 0, or null
extern "C" int intra_chroma(void* cb, void* cr, const void* rcb, const void* rcr,
                            const void* params, const void* top_cb, const void* top_cr,
                            void* sync, int mb_h, int mb_w, int ch_h, int mid, int mx,
                            void* stream, int* n_launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  if (ch_h != 8 && ch_h != 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(sync, 0, sizeof(int) * (mb_h + 1), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  int *pcb = static_cast<int*>(cb), *pcr = static_cast<int*>(cr);
  const int *prcb = static_cast<const int*>(rcb), *prcr = static_cast<const int*>(rcr);
  const int* prm = static_cast<const int*>(params);
  const int *tcb = static_cast<const int*>(top_cb), *tcr = static_cast<const int*>(top_cr);
  int* psync = static_cast<int*>(sync);
  const bool bd8 = mx == 255;
  if (ch_h == 8 && bd8)
    intra_chroma_rows<8, true><<<mb_h, 128, 0, s>>>(pcb, pcr, prcb, prcr, prm, tcb, tcr, psync,
                                                    mb_h, mb_w, mid, mx);
  else if (ch_h == 8)
    intra_chroma_rows<8, false><<<mb_h, 128, 0, s>>>(pcb, pcr, prcb, prcr, prm, tcb, tcr, psync,
                                                     mb_h, mb_w, mid, mx);
  else if (bd8)
    intra_chroma_rows<16, true><<<mb_h, 256, 0, s>>>(pcb, pcr, prcb, prcr, prm, tcb, tcr, psync,
                                                     mb_h, mb_w, mid, mx);
  else
    intra_chroma_rows<16, false><<<mb_h, 256, 0, s>>>(pcb, pcr, prcb, prcr, prm, tcb, tcr,
                                                      psync, mb_h, mb_w, mid, mx);
  *n_launched = 1;
  return static_cast<int>(cudaGetLastError());
}
