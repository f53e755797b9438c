// Per-document visible length at the acked perspective.
//
//   out[b] = sum_c length[b, c]  where  c < count[b]
//                                  and  ins_seq[b, c] <= seq[b]
//                                  and  !(rem_seq[b, c] <= seq[b])
//
// Replaces: fluidframework_tpu/mergetree/pallas_ops.py,
//   _pallas_summary_lengths -> _summary_len_kernel (8-doc row blocks,
//   predicate + mask + reduce fused in one VMEM pass).
//
// Bound on the H100: bytes. Three int32 [B, C] planes are read once and
// [B] int32 written: 12 B per slot, 30.7 MB at B=10,000, C=256, which is
// about 9 us at 3.35 TB/s; the predicate is a handful of integer
// operations per slot, far below the ALU rate.
//
// Design: one warp per document, lanes striding over C (consecutive lanes
// on consecutive addresses, so every plane is read in 128-byte lines), the
// predicate in registers, and an int32 warp reduction (__reduce_add_sync).
// Integer sums are order-free, so the result is bit-exact against any
// other order of summation, including the JAX one. Nothing is written but
// the [B] totals.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void summary_len_kernel(const int* __restrict__ length,
                                   const int* __restrict__ ins_seq,
                                   const int* __restrict__ rem_seq,
                                   const int* __restrict__ count,
                                   const int* __restrict__ seq,
                                   int* __restrict__ out, int batch,
                                   int capacity) {
  const int doc = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (doc >= batch) return;  // uniform per warp
  const long long row = static_cast<long long>(doc) * capacity;
  const int cnt = count[doc];
  const int s = seq[doc];
  unsigned acc = 0;
  for (int c = lane; c < capacity; c += 32) {
    const bool vis = c < cnt && ins_seq[row + c] <= s && !(rem_seq[row + c] <= s);
    if (vis) acc += static_cast<unsigned>(length[row + c]);
  }
  acc = __reduce_add_sync(kFull, acc);
  if (lane == 0) out[doc] = static_cast<int>(acc);
}

}  // namespace

extern "C" int fluid_summary_len(const void* length, const void* ins_seq,
                                 const void* rem_seq, const void* count,
                                 const void* seq, void* out, int batch,
                                 int capacity, void* stream) {
  const int threads = 256;  // 8 documents per block
  const int docs_per_block = threads / 32;
  const int blocks = (batch + docs_per_block - 1) / docs_per_block;
  if (batch > 0) {
    summary_len_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(length), static_cast<const int*>(ins_seq),
        static_cast<const int*>(rem_seq), static_cast<const int*>(count),
        static_cast<const int*>(seq), static_cast<int*>(out), batch,
        capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
