// Zamboni: the left-pack of the segment rows not yet freed, over [B, C]
// tables, in three modes of one kernel.
//
// Replaces: fluidframework_tpu/mergetree/kernel.py, _pack_src (:485), the
//   addressing that compaction and extraction share, under
//   - kCompact: _compact_one (:503), behind compact / compact_batched
//     (:527 / :532) and compact_pages (:655). The rows kept (index below
//     count and not removed at or before min_seq, a signed int32 compare,
//     so the sentinels DEV_UNASSIGNED and DEV_NO_REMOVE never count as
//     removed) move to the front in order; the slots from the new count
//     to C take make_state's blanks; count becomes the rows kept.
//   - kCompactExtract: _compact_extract_one (:710), behind
//     compact_extract_batched (:736) and compact_extract_paged (:668): the
//     compacted state, whose planes are also the packed rows, plus the
//     packed rem_client plane (rem_clients' first slot of each compacted
//     row, -1 past the count).
//   - kExtract: _extract_one (:697), behind extract_visible_batched
//     (:723): the packed rows alone (origin_op, origin_off, length, anno,
//     ins_seq, ins_client, rem_seq, rem_client, count) with no compaction;
//     the slots from the count to C repeat the input's row C - 1, as
//     JAX's gather with sources initialised to C - 1 does.
//   Every mode may also write the pre-compaction count plane (stats=True).
//   XLA compiles these into a scatter of destinations and one gather per
//   column; on the TPU they are programs of the summarize path, not Pallas
//   kernels.
//
// Bound on the H100: bytes. Each kept row is read once and written once
//   ((8 + K + A) ints in the compacting modes), the padding written once;
//   no arithmetic beyond a compare, a ballot and a popcount a row.
//
// Design: one block a document, a tile loop over the live prefix of C
//   (the rows below min(count, C); none past it can be kept) with a
//   block-wide exclusive scan of the keep flags: __ballot_sync and __popc
//   inside a warp, the warps' totals through shared memory, and a running
//   base carried across tiles in a register (every thread sums the same
//   totals). A kept row scatters to its destination, which is the gather
//   of _pack_src read backwards: the destinations are unique and in
//   order. Then the padding loop writes the slots past the new count.
//   Out of place: the input is never written (the lane store keeps its
//   pre-compaction state until it adopts the result). The block takes
//   min(256, C rounded up to 32) threads, so a narrow table does not idle
//   most of a block. K and A are run-time ints; a row's K and A slots are
//   copied by its own thread. The kernel carries no __launch_bounds__:
//   with (256) ptxas capped the fused mode's registers and it spilled on
//   sm_90a; without it no mode spills (the -Xptxas -v report that
//   chip_smoke.py prints).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kUnassigned = 0x7fffffff;  // DEV_UNASSIGNED
constexpr int kNoRemove = 0x7ffffffe;    // DEV_NO_REMOVE
enum { kCompact = 0, kCompactExtract = 1, kExtract = 2 };

struct ZamboniArgs {
  // the state in: [B, C] planes, [B, C, K] and [B, C, A], [B] scalars
  const int* length;
  const int* ins_seq;
  const int* ins_client;
  const int* local_seq;
  const int* rem_seq;
  const int* rem_local_seq;
  const int* rem_clients;
  const int* origin_op;
  const int* origin_off;
  const int* anno;
  const int* count;
  const int* min_seq;
  // the compacted state out (kCompact, kCompactExtract), same shapes
  int* c_length;
  int* c_ins_seq;
  int* c_ins_client;
  int* c_local_seq;
  int* c_rem_seq;
  int* c_rem_local_seq;
  int* c_rem_clients;
  int* c_origin_op;
  int* c_origin_off;
  int* c_anno;
  int* c_count;
  // the packed rows out: all in kExtract, rem_client alone in
  // kCompactExtract ([B, C], anno [B, C, A], count [B])
  int* x_origin_op;
  int* x_origin_off;
  int* x_length;
  int* x_anno;
  int* x_ins_seq;
  int* x_ins_client;
  int* x_rem_seq;
  int* x_rem_client;
  int* x_count;
  // the pre-compaction count plane [B], or null
  int* pre_count;
  int capacity;
  int k_slots;
  int a_slots;
};

// Row i of the input to slot d of the outputs the mode writes.
template <int kMode>
__device__ __forceinline__ void move_row(const ZamboniArgs& a, long long row,
                                         int i, int d) {
  const long long s = row + i, t = row + d;
  const int K = a.k_slots, A = a.a_slots;
  if (kMode != kExtract) {
    a.c_length[t] = a.length[s];
    a.c_ins_seq[t] = a.ins_seq[s];
    a.c_ins_client[t] = a.ins_client[s];
    a.c_local_seq[t] = a.local_seq[s];
    a.c_rem_seq[t] = a.rem_seq[s];
    a.c_rem_local_seq[t] = a.rem_local_seq[s];
    a.c_origin_op[t] = a.origin_op[s];
    a.c_origin_off[t] = a.origin_off[s];
    for (int k = 0; k < K; ++k)
      a.c_rem_clients[t * K + k] = a.rem_clients[s * K + k];
    for (int k = 0; k < A; ++k) a.c_anno[t * A + k] = a.anno[s * A + k];
    if (kMode == kCompactExtract) a.x_rem_client[t] = a.rem_clients[s * K];
  } else {
    a.x_origin_op[t] = a.origin_op[s];
    a.x_origin_off[t] = a.origin_off[s];
    a.x_length[t] = a.length[s];
    a.x_ins_seq[t] = a.ins_seq[s];
    a.x_ins_client[t] = a.ins_client[s];
    a.x_rem_seq[t] = a.rem_seq[s];
    a.x_rem_client[t] = a.rem_clients[s * K];
    for (int k = 0; k < A; ++k) a.x_anno[t * A + k] = a.anno[s * A + k];
  }
}

// Slot d past the new count: make_state's blanks when compacting, the
// input's last row when extracting.
template <int kMode>
__device__ __forceinline__ void pad_row(const ZamboniArgs& a, long long row,
                                        int d) {
  const long long t = row + d;
  const int K = a.k_slots, A = a.a_slots;
  if (kMode != kExtract) {
    a.c_length[t] = 0;
    a.c_ins_seq[t] = kUnassigned;
    a.c_ins_client[t] = -1;
    a.c_local_seq[t] = 0;
    a.c_rem_seq[t] = kNoRemove;
    a.c_rem_local_seq[t] = 0;
    a.c_origin_op[t] = -1;
    a.c_origin_off[t] = 0;
    for (int k = 0; k < K; ++k) a.c_rem_clients[t * K + k] = -1;
    for (int k = 0; k < A; ++k) a.c_anno[t * A + k] = -1;
    if (kMode == kCompactExtract) a.x_rem_client[t] = -1;
  } else {
    move_row<kExtract>(a, row, a.capacity - 1, d);
  }
}

template <int kMode>
__global__ void zamboni_kernel(ZamboniArgs a) {
  extern __shared__ int smem[];  // the warps' keep totals of a tile
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int cap = a.capacity;
  const long long row = static_cast<long long>(b) * cap;
  const int cnt = a.count[b];
  const int mseq = a.min_seq[b];
  const int live = cnt < 0 ? 0 : min(cnt, cap);  // uniform per block
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
  for (int t0 = 0; t0 < live; t0 += threads) {
    const int i = t0 + tid;
    const bool keep = i < live && !(a.rem_seq[row + i] <= mseq);
    const unsigned m = __ballot_sync(kFull, keep);
    if (lane == 0) smem[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < warps; ++w) {
      const int v = smem[w];
      before += w < warp ? v : 0;
      total += v;
    }
    __syncthreads();  // every total read before the next tile writes them
    if (keep) move_row<kMode>(a, row, i, base + before + __popc(m & below));
    base += total;
  }
  for (int d = base + tid; d < cap; d += threads) pad_row<kMode>(a, row, d);
  if (tid == 0) {
    if (kMode != kExtract) a.c_count[b] = base;
    if (kMode == kExtract) a.x_count[b] = base;
    if (a.pre_count != nullptr) a.pre_count[b] = cnt;
  }
}

}  // namespace

// ptrs, in order: the state in (length, ins_seq, ins_client, local_seq,
// rem_seq, rem_local_seq, rem_clients, origin_op, origin_off, anno, count,
// min_seq); the compacted state out (the ten row planes in the same order
// and count; null in the extract mode); the packed rows out (origin_op,
// origin_off, length, anno, ins_seq, ins_client, rem_seq, rem_client,
// count; all set in the extract mode, rem_client alone in the fused mode,
// null in the compact mode); the pre-compaction count plane (or null).
// mode: 0 compact, 1 compact + extract, 2 extract. A mode or shape the
// kernel does not take (B, C or K below 1, A below 0) is refused with
// cudaErrorInvalidValue and nothing runs. Returns cudaGetLastError.
extern "C" int fluid_zamboni(void** ptrs, int mode, int batch, int capacity,
                             int k_slots, int a_slots, void* stream) {
  if (mode < kCompact || mode > kExtract || batch < 1 || capacity < 1 ||
      k_slots < 1 || a_slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ZamboniArgs a;
  a.length = static_cast<const int*>(ptrs[0]);
  a.ins_seq = static_cast<const int*>(ptrs[1]);
  a.ins_client = static_cast<const int*>(ptrs[2]);
  a.local_seq = static_cast<const int*>(ptrs[3]);
  a.rem_seq = static_cast<const int*>(ptrs[4]);
  a.rem_local_seq = static_cast<const int*>(ptrs[5]);
  a.rem_clients = static_cast<const int*>(ptrs[6]);
  a.origin_op = static_cast<const int*>(ptrs[7]);
  a.origin_off = static_cast<const int*>(ptrs[8]);
  a.anno = static_cast<const int*>(ptrs[9]);
  a.count = static_cast<const int*>(ptrs[10]);
  a.min_seq = static_cast<const int*>(ptrs[11]);
  a.c_length = static_cast<int*>(ptrs[12]);
  a.c_ins_seq = static_cast<int*>(ptrs[13]);
  a.c_ins_client = static_cast<int*>(ptrs[14]);
  a.c_local_seq = static_cast<int*>(ptrs[15]);
  a.c_rem_seq = static_cast<int*>(ptrs[16]);
  a.c_rem_local_seq = static_cast<int*>(ptrs[17]);
  a.c_rem_clients = static_cast<int*>(ptrs[18]);
  a.c_origin_op = static_cast<int*>(ptrs[19]);
  a.c_origin_off = static_cast<int*>(ptrs[20]);
  a.c_anno = static_cast<int*>(ptrs[21]);
  a.c_count = static_cast<int*>(ptrs[22]);
  a.x_origin_op = static_cast<int*>(ptrs[23]);
  a.x_origin_off = static_cast<int*>(ptrs[24]);
  a.x_length = static_cast<int*>(ptrs[25]);
  a.x_anno = static_cast<int*>(ptrs[26]);
  a.x_ins_seq = static_cast<int*>(ptrs[27]);
  a.x_ins_client = static_cast<int*>(ptrs[28]);
  a.x_rem_seq = static_cast<int*>(ptrs[29]);
  a.x_rem_client = static_cast<int*>(ptrs[30]);
  a.x_count = static_cast<int*>(ptrs[31]);
  a.pre_count = static_cast<int*>(ptrs[32]);
  a.capacity = capacity;
  a.k_slots = k_slots;
  a.a_slots = a_slots;
  const int rounded = (capacity + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  void (*kern)(ZamboniArgs) = mode == kCompact ? zamboni_kernel<kCompact>
      : mode == kCompactExtract ? zamboni_kernel<kCompactExtract>
                                : zamboni_kernel<kExtract>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<batch, threads, kMaxWarps * sizeof(int), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
