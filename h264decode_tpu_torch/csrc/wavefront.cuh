// Row wavefront over macroblocks in one persistent launch, for Hopper.
//
// A frame whose MB (x, y) depends on MBs of row y-1 up to some column runs
// as one launch of P * mb_h blocks, one block per MB row of each of P
// independent planes (P = 1, or 3 for the Y, Cb and Cr planes of 4:4:4),
// walking its row left to right:
//
//   (plane, row) = take_row(sync, P)           // ticket, not blockIdx
//   progress = sync + plane * mb_h             // the plane's counters
//   for x in 0..mb_w-1:
//     wait_row(progress, row, need(x))         // row-1 has finished MBs 0..need-1
//     ... the MB ...
//     publish_row(progress, row, x + 1)        // MBs 0..x of this row done
//
// The caller chooses need: min(x + 2, mb_w) where MB (x, y) needs row y-1's
// MB x+1 (intra luma's top-right neighbour; deblocking, luma and chroma,
// whose row above is final only after the right neighbour's left-edge
// filter), x + 1 where it needs row y-1 only up to MB x (intra chroma,
// which has no top-right neighbour).
//
// sync is int32[1 + P * mb_h], zeroed on the stream before the launch:
// sync[0] is the ticket counter, sync[1 + p * mb_h + y] the number of MBs
// row y of plane p has finished. Ticket t is row t / P of plane t % P, so
// the P planes' rows are handed out interleaved, row 0 of every plane
// first. A block only ever waits on the row above in its own plane: row r
// of plane p (ticket t = r * P + p) waits on row r-1 of plane p, ticket
// t - P, which was handed out before t to a block already running. So there
// is no deadlock for any P and mb_h, whether or not all blocks fit on the
// card at once (4K has 135 MB rows, the H100 132 SMs), and the planes'
// chains run side by side.
//
// Ordering: the block's writes, __syncthreads(), then thread 0 releases the
// progress count (fence.acq_rel.gpu + relaxed store, as CUTLASS's
// cutlass/barrier.h does); the waiting block's thread 0 polls with a
// device-scope acquire load, then __syncthreads(). Planes that blocks of the
// launch write are read with plain (or L2-only, __ldcg) loads after that
// acquire, never through the read-only path.

#pragma once

namespace wavefront {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The (plane, MB row) this block walks, from the next ticket t: plane
// t % planes, row t / planes (uniform over the block).
struct RowTicket {
  int plane, row;
};

__device__ __forceinline__ RowTicket take_row(int* sync, int planes) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  return {ticket % planes, ticket / planes};
}

// A single wait this long (5 s of the global timer, whatever the SM clock)
// means a broken hand-off: trap, so that the launch fails with an error
// instead of spinning forever. A trap is a sticky error: the process's CUDA
// context is unusable afterwards. A healthy wait lasts microseconds; only a
// card time-sliced with other contexts for seconds, or a debugger holding
// the kernel, could reach the limit without a broken hand-off.
constexpr unsigned long long kWaitLimitNs = 5000000000ULL;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block until row-1 has finished `need` MBs (row 0 waits for nothing).
// progress = sync + plane * mb_h: the plane's counters sit at progress[1 + y].
__device__ __forceinline__ void wait_row(const int* progress, int row, int need) {
  if (threadIdx.x == 0 && row > 0) {
    const int* p = progress + row;  // progress of row - 1
    const unsigned long long t0 = global_ns();
    // a short, fixed back-off: the wait is on the chain's critical path, and
    // at most mb_h threads poll
    while (ld_acquire(p) < need) {
      __nanosleep(32);
      if (global_ns() - t0 > kWaitLimitNs) __trap();
    }
  }
  __syncthreads();
}

// After every thread of the block has written the MB: row has done `done` MBs.
__device__ __forceinline__ void publish_row(int* progress, int row, int done) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(progress + 1 + row, done);
}

}  // namespace wavefront
