// The serving window's narrow result: one window's flat16 in one launch.
//
// Replaces: the flat16 pack of fluidframework_tpu/server/serve_step.py,
//   _serve_window_impl (the seq/msn deltas, flags, scalar halves, bits,
//   per-lane planes, paged tail and stats plane, which XLA fuses into the
//   window's one program; the port's plain version is server/
//   serve_step._pack_window_plain). The layout is serve_step.flat16_layout:
//   seq_d, msn_d, flags ([B, T] each), next_seq and msn_base as int16
//   (lo, hi) halves, the bits (msn_ok, the ticket overflow, one per merge
//   group and LWW bucket), the per-lane overflow and occupancy planes
//   (merge groups then LWW buckets), the paged tail (count, min_seq, seq
//   halves per group) and the stats plane's halves. Every int16 is the
//   int32's low 16 bits, as torch's and XLA's casts give.
//
// Bound on the H100: bytes. The [B, T] ticket results (10 B a message)
//   and the per-lane columns (the kind planes, 4 B an op) are read once,
//   6 B a message and a few bytes a lane written: microseconds at
//   3.35 TB/s.
//
// Design: one grid. The first blocks take the documents, a warp each:
//   one pass over T for the admitted msn minimum (the msn base) and the
//   counts, a second that writes seq_d, msn_d and flags coalesced. The
//   other blocks take the groups' and buckets' lanes, a thread each (the
//   pointer table rides in the kernel's parameters). Every total (the
//   largest msn delta, the overflow bits, the stats) is a warp reduction
//   and then an integer atomic into a zeroed scratch; integer sums do not
//   depend on their order, so the result is deterministic. The last block
//   to finish (a counter after a __threadfence) writes the bits and the
//   stats.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kDocsPerBlock = kThreads / 32;
constexpr int kMaxEntries = 32;  // merge groups + LWW buckets
constexpr int kBig = 1 << 30;
constexpr int kMsnCap = 32000;
constexpr int kMergeKinds = 6;  // INSERT .. INSERT_RUN = 1 .. 6
constexpr int kStats = 15;      // telemetry/device_stats.N_SERVE

// scratch words (the wrapper zeroes them)
enum {
  kDone = 0,
  kMaxDelta,
  kTicketOver,
  kAdmitted,
  kNacked,
  kNotJoined,
  kKindCount,                       // 6 words
  kLwwOps = kKindCount + kMergeKinds,
  kMergeOverSum,
  kLwwOverSum,
  kCountSum,
  kOccSum,
  kOverAny,                         // kMaxEntries words
  kAnyOp = kOverAny + kMaxEntries,  // kMaxEntries words
  kScratchWords = kAnyOp + kMaxEntries
};

struct PackEntry {
  const unsigned char* over;  // [n] bool: the state's overflow
  const int* count;           // [n]: merge count, or LWW occupancy
  const int* kinds;           // [n, tm] admitted kinds
  const short* narrow_over;   // [n] (paged merge groups; else null)
  const int* narrow_count;    // [n] (paged merge groups; else null)
  const int* narrow_min;
  const int* narrow_seq;
  int n;
  int tm;
  int lww;
  int block0;   // its first block after the documents' blocks
  int over_at;  // its overflow plane in flat16
  int occ_at;   // its occupancy plane
  int tail_at;  // its paged tail (paged merge groups)
};

struct PackArgs {
  const int* next_seq;          // [B]
  const unsigned char* t_over;  // [B] bool
  const int* seq;               // [B, T]
  const int* msn;               // [B, T]
  const unsigned char* nacked;  // [B, T] bool
  const unsigned char* not_joined;
  short* out;
  int* scratch;
  int batch;
  int steps;
  int entries;
  int doc_blocks;
  int bits_at;
  int stats_at;  // -1 without stats
  int noop_skip;
  PackEntry e[kMaxEntries];
};

__device__ __forceinline__ short lo16(int x) {
  return static_cast<short>(x & 0xFFFF);
}
__device__ __forceinline__ short hi16(int x) {
  return static_cast<short>(x >> 16);
}
__device__ __forceinline__ int sub(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) -
                          static_cast<unsigned>(y));
}
__device__ __forceinline__ void warp_add(int* at, unsigned v) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0 && v != 0u)
    atomicAdd(at, static_cast<int>(v));
}

__device__ __forceinline__ void pack_document(const PackArgs& a, int b) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(b) * a.steps;
  int base = kBig;
  unsigned admitted = 0, nacked = 0, not_joined = 0;
  for (int t = lane; t < a.steps; t += 32) {
    const bool adm = a.seq[row + t] > 0;
    if (adm) base = min(base, a.msn[row + t]);
    admitted += adm ? 1u : 0u;
    nacked += a.nacked[row + t] ? 1u : 0u;
    not_joined += a.not_joined[row + t] ? 1u : 0u;
  }
  base = __reduce_min_sync(kFull, base);
  if (base == kBig) base = 0;
  const int next = a.next_seq[b];
  const long long bt = static_cast<long long>(a.batch) * a.steps;
  int max_delta = 0;
  for (int t = lane; t < a.steps; t += 32) {
    const int s = a.seq[row + t];
    const bool adm = s > 0;
    const int d = adm ? sub(a.msn[row + t], base) : 0;
    max_delta = max(max_delta, d);
    a.out[row + t] = static_cast<short>(adm ? sub(next, s) : -1);
    a.out[bt + row + t] = static_cast<short>(min(d, kMsnCap));
    a.out[2 * bt + row + t] = static_cast<short>(
        (a.nacked[row + t] ? 1 : 0) | (a.not_joined[row + t] ? 2 : 0));
  }
  max_delta = __reduce_max_sync(kFull, max_delta);
  warp_add(a.scratch + kAdmitted, admitted);
  warp_add(a.scratch + kNacked, nacked);
  warp_add(a.scratch + kNotJoined, not_joined);
  if (lane == 0) {
    const long long s0 = 3 * bt;
    a.out[s0 + b] = lo16(next);
    a.out[s0 + a.batch + b] = hi16(next);
    a.out[s0 + 2 * a.batch + b] = lo16(base);
    a.out[s0 + 3 * a.batch + b] = hi16(base);
    atomicMax(a.scratch + kMaxDelta, max_delta);
    if (a.t_over[b]) atomicOr(a.scratch + kTicketOver, 1);
  }
}

__device__ __forceinline__ void pack_lane(const PackArgs& a,
                                          const PackEntry& e, int ei,
                                          int i) {
  const bool in = i < e.n;
  bool over = false;
  int count = 0;
  unsigned kind_n[kMergeKinds] = {0, 0, 0, 0, 0, 0};
  unsigned ops = 0;
  if (in) {
    over = e.over[i] != 0;
    count = e.count[i];
    const bool paged = e.narrow_over != nullptr;
    a.out[e.over_at + i] = paged ? e.narrow_over[i]
                                 : static_cast<short>(over ? 1 : 0);
    a.out[e.occ_at + i] =
        static_cast<short>(paged ? e.narrow_count[i] : count);
    if (paged) {
      const int n = e.n;
      a.out[e.tail_at + i] = lo16(e.narrow_count[i]);
      a.out[e.tail_at + n + i] = hi16(e.narrow_count[i]);
      a.out[e.tail_at + 2 * n + i] = lo16(e.narrow_min[i]);
      a.out[e.tail_at + 3 * n + i] = hi16(e.narrow_min[i]);
      a.out[e.tail_at + 4 * n + i] = lo16(e.narrow_seq[i]);
      a.out[e.tail_at + 5 * n + i] = hi16(e.narrow_seq[i]);
    }
    if (a.stats_at >= 0) {
      const int* k = e.kinds + static_cast<long long>(i) * e.tm;
      for (int t = 0; t < e.tm; ++t) {
        const int kind = k[t];
        ops += kind != 0 ? 1u : 0u;
#pragma unroll
        for (int m = 0; m < kMergeKinds; ++m)
          kind_n[m] += kind == m + 1 ? 1u : 0u;
      }
    }
  }
  if (__any_sync(kFull, over) && (threadIdx.x & 31) == 0)
    atomicOr(a.scratch + kOverAny + ei, 1);
  if (a.stats_at < 0) return;  // uniform
  if (__any_sync(kFull, ops != 0u) && (threadIdx.x & 31) == 0)
    atomicOr(a.scratch + kAnyOp + ei, 1);
  if (e.lww) {
    warp_add(a.scratch + kLwwOps, ops);
    warp_add(a.scratch + kLwwOverSum, over ? 1u : 0u);
    warp_add(a.scratch + kOccSum, static_cast<unsigned>(count));
  } else {
#pragma unroll
    for (int k = 0; k < kMergeKinds; ++k)
      warp_add(a.scratch + kKindCount + k, kind_n[k]);
    warp_add(a.scratch + kMergeOverSum, over ? 1u : 0u);
    warp_add(a.scratch + kCountSum, static_cast<unsigned>(count));
  }
}

__device__ __forceinline__ int read_total(int* at) {
  return atomicAdd(at, 0);
}

__device__ __forceinline__ void finish(const PackArgs& a) {
  int* s = a.scratch;
  a.out[a.bits_at] =
      static_cast<short>(read_total(s + kMaxDelta) < kMsnCap ? 1 : 0);
  a.out[a.bits_at + 1] = static_cast<short>(read_total(s + kTicketOver));
  for (int ei = 0; ei < a.entries; ++ei)
    a.out[a.bits_at + 2 + ei] =
        static_cast<short>(read_total(s + kOverAny + ei));
  if (a.stats_at < 0) return;
  int st[kStats];
#pragma unroll
  for (int k = 0; k < kMergeKinds; ++k) st[k] = read_total(s + kKindCount + k);
  st[6] = read_total(s + kLwwOps);
  st[7] = read_total(s + kAdmitted);
  st[8] = read_total(s + kNacked);
  st[9] = read_total(s + kNotJoined);
  st[10] = read_total(s + kMergeOverSum);
  st[11] = read_total(s + kLwwOverSum);
  int skips = 0;
  if (a.noop_skip)
    for (int ei = 0; ei < a.entries; ++ei)
      skips += read_total(s + kAnyOp + ei) == 0 ? 1 : 0;
  st[12] = skips;
  st[13] = read_total(s + kCountSum);
  st[14] = read_total(s + kOccSum);
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
    a.out[a.stats_at + k] = lo16(st[k]);
    a.out[a.stats_at + kStats + k] = hi16(st[k]);
  }
}

__global__ void __launch_bounds__(kThreads) window_pack_kernel(PackArgs a) {
  const int blk = blockIdx.x;
  if (blk < a.doc_blocks) {
    const int b = blk * kDocsPerBlock + (threadIdx.x >> 5);
    if (b < a.batch) pack_document(a, b);  // uniform per warp
  } else {
    // The block's entry: the last whose first block is at or before it.
    // The table is read at constant indices only (an indexed read of a
    // kernel parameter would copy the table to local memory).
    const int g = blk - a.doc_blocks;
    int ei = 0;
#pragma unroll
    for (int k = 1; k < kMaxEntries; ++k)
      if (k < a.entries && a.e[k].block0 <= g) ei = k;
    PackEntry e = a.e[0];
#pragma unroll
    for (int k = 1; k < kMaxEntries; ++k)
      if (k == ei) e = a.e[k];
    pack_lane(a, e, ei, (g - e.block0) * kThreads + threadIdx.x);
  }
  // The last block to finish writes the totals.
  __threadfence();
  int last = 0;
  if (threadIdx.x == 0)
    last = atomicAdd(a.scratch + kDone, 1) == static_cast<int>(gridDim.x) - 1;
  if (__syncthreads_or(last) && threadIdx.x == 0) {
    __threadfence();
    finish(a);
  }
}

}  // namespace

// ptrs, in order: next_seq, the ticket overflow ([B]), seq, min_seq,
// nacked, not_joined ([B, T] ticket results), flat16 out, scratch (int32,
// zeroed, fluid_window_pack_scratch_words() of them); then seven per
// entry (merge groups first, then LWW buckets): overflow, count (or
// occupancy), kinds, and the paged narrow overflow, count, min_seq and
// seq (null except for paged merge groups). ints: per entry n, tm, lww,
// over_at, occ_at, tail_at. `stats_at` is -1 without the stats plane. A
// shape the kernel does not take (B or T below 1, more than 32 entries)
// is refused with cudaErrorInvalidValue and nothing runs. Returns
// cudaGetLastError.
extern "C" int fluid_window_pack_scratch_words() { return kScratchWords; }

extern "C" int fluid_window_pack(void** ptrs, const int* ints, int batch,
                                 int steps, int entries, int bits_at,
                                 int stats_at, int noop_skip, void* stream) {
  if (batch < 1 || steps < 1 || entries < 0 || entries > kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a;
  a.next_seq = static_cast<const int*>(ptrs[0]);
  a.t_over = static_cast<const unsigned char*>(ptrs[1]);
  a.seq = static_cast<const int*>(ptrs[2]);
  a.msn = static_cast<const int*>(ptrs[3]);
  a.nacked = static_cast<const unsigned char*>(ptrs[4]);
  a.not_joined = static_cast<const unsigned char*>(ptrs[5]);
  a.out = static_cast<short*>(ptrs[6]);
  a.scratch = static_cast<int*>(ptrs[7]);
  a.batch = batch;
  a.steps = steps;
  a.entries = entries;
  a.doc_blocks = (batch + kDocsPerBlock - 1) / kDocsPerBlock;
  a.bits_at = bits_at;
  a.stats_at = stats_at;
  a.noop_skip = noop_skip;
  int blocks = 0;
  for (int ei = 0; ei < entries; ++ei) {
    PackEntry& e = a.e[ei];
    void** p = ptrs + 8 + 7 * ei;
    const int* v = ints + 6 * ei;
    e.over = static_cast<const unsigned char*>(p[0]);
    e.count = static_cast<const int*>(p[1]);
    e.kinds = static_cast<const int*>(p[2]);
    e.narrow_over = static_cast<const short*>(p[3]);
    e.narrow_count = static_cast<const int*>(p[4]);
    e.narrow_min = static_cast<const int*>(p[5]);
    e.narrow_seq = static_cast<const int*>(p[6]);
    e.n = v[0];
    e.tm = v[1];
    e.lww = v[2];
    e.over_at = v[3];
    e.occ_at = v[4];
    e.tail_at = v[5];
    e.block0 = blocks;
    if (e.n < 0 || e.tm < 0) return static_cast<int>(cudaErrorInvalidValue);
    blocks += (e.n + kThreads - 1) / kThreads;
  }
  const int grid = a.doc_blocks + blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  window_pack_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
