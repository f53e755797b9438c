// The narrow device-to-host wire of a summary extraction: the packed rows'
// first mx slots of each document as int16 deltas, one block a document.
//
// Replaces: fluidframework_tpu/mergetree/kernel.py, _narrow_pack (:817), a
//   jitted program (masked minima, deltas, clamps and casts) that
//   fetch_extracted (:902) runs at the host-chosen slice width mx. For
//   each document b, with live = slot j below counts[b]:
//   - base_ins is the least ins_seq of the live rows whose insert is
//     acked (ins_seq != DEV_UNASSIGNED), base_rem the least rem_seq of the
//     live rows with a real remove (neither DEV_NO_REMOVE nor
//     DEV_UNASSIGNED), base_anno the least annotate id >= 0 of the live
//     rows over all mx x A slots jointly; each minimum starts at 1 << 30
//     and a base that stays there becomes 0;
//   - d_ins = ins_seq - base_ins on acked rows, else -1; d_rem = rem_seq -
//     base_rem on real removes, -2 on a live pending remove, else -1;
//     d_anno = id - base_anno on live ids >= 0, else -1 (int32, wrapping);
//   - ok (meta row 3) is 1 when every value lies in [-2, 32000]: length,
//     origin_off, ins_client, rem_client, d_ins and d_rem on live rows,
//     d_anno on live ids (a masked-out value counts as 0); a document
//     that escapes is refetched exactly by the caller;
//   - stacked16 [6, B, mx] holds length, origin_off (0 past the count),
//     ins_client, rem_client (-1 past the count), d_ins and d_rem; anno16
//     [B, mx, A] holds d_anno; each is clamped to the int16 range before
//     the cast. op32 [B, mx] is origin_op as it is; meta [4, B] holds
//     base_ins, base_rem, base_anno and ok.
//
// Bound on the H100: bytes: the first mx slots of 7 + A int32 planes read
//   once, the int16 wire and op32 written once; a few compares a value.
//
// Design: one block a document, two passes over its mx slots. Pass 1
//   takes the three minima (a warp's through __reduce_min_sync, the
//   block's through shared memory) and the range checks that need no
//   base; pass 2 takes the deltas, the rest of the checks and the writes.
//   The ok bit is one __syncthreads_and of each thread's checks. The
//   annotate slots are walked as one flat run of mx x A ints, which is
//   where they lie in [B, C, A]. The block takes min(256, mx rounded up
//   to 32) threads.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kUnassigned = 0x7fffffff;  // DEV_UNASSIGNED
constexpr int kNoRemove = 0x7ffffffe;    // DEV_NO_REMOVE
constexpr int kBig = 1 << 30;
constexpr int kNarrowMax = 32000;

struct NarrowArgs {
  // the packed rows in: [B, C] planes, anno [B, C, A], counts [B]
  const int* origin_op;
  const int* origin_off;
  const int* length;
  const int* anno;
  const int* ins_seq;
  const int* ins_client;
  const int* rem_seq;
  const int* rem_client;
  const int* counts;
  // the wire out: [6, B, mx] and [B, mx, A] int16, [B, mx] and [4, B]
  short* stacked16;
  short* anno16;
  int* op32;
  int* meta;
  int batch;
  int capacity;
  int mx;
  int a_slots;
};

__device__ __forceinline__ bool in_range(int x) {
  return x >= -2 && x <= kNarrowMax;
}

__device__ __forceinline__ short n16(int x) {
  return static_cast<short>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}

__device__ __forceinline__ int wrap_sub(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) -
                          static_cast<unsigned>(y));
}

__global__ void __launch_bounds__(kMaxThreads) narrow_pack_kernel(
    NarrowArgs a) {
  extern __shared__ int smem[];  // the warps' three minima
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int mx = a.mx, A = a.a_slots, B = a.batch;
  const long long row = static_cast<long long>(b) * a.capacity;
  const long long arow = row * A;
  const int cnt = a.counts[b];

  // pass 1: the minima, and the checks that need no base
  int m_ins = kBig, m_rem = kBig, m_anno = kBig;
  bool ok = true;
  for (int j = tid; j < mx; j += threads) {
    const bool live = j < cnt;
    const int is = a.ins_seq[row + j], rs = a.rem_seq[row + j];
    if (live && is != kUnassigned) m_ins = min(m_ins, is);
    if (live && rs != kNoRemove && rs != kUnassigned) m_rem = min(m_rem, rs);
    ok = ok && in_range(live ? a.length[row + j] : 0) &&
         in_range(live ? a.origin_off[row + j] : 0) &&
         in_range(live ? a.ins_client[row + j] : 0) &&
         in_range(live ? a.rem_client[row + j] : 0);
  }
  for (int e = tid; e < mx * A; e += threads) {
    const int v = a.anno[arow + e];
    if (e / A < cnt && v >= 0) m_anno = min(m_anno, v);
  }
  m_ins = __reduce_min_sync(kFull, m_ins);
  m_rem = __reduce_min_sync(kFull, m_rem);
  m_anno = __reduce_min_sync(kFull, m_anno);
  if (lane == 0) {
    smem[warp] = m_ins;
    smem[kMaxWarps + warp] = m_rem;
    smem[2 * kMaxWarps + warp] = m_anno;
  }
  __syncthreads();
  for (int w = 0; w < warps; ++w) {
    m_ins = min(m_ins, smem[w]);
    m_rem = min(m_rem, smem[kMaxWarps + w]);
    m_anno = min(m_anno, smem[2 * kMaxWarps + w]);
  }
  const int base_ins = m_ins == kBig ? 0 : m_ins;
  const int base_rem = m_rem == kBig ? 0 : m_rem;
  const int base_anno = m_anno == kBig ? 0 : m_anno;

  // pass 2: the deltas, their checks and the writes
  const long long plane = static_cast<long long>(B) * mx;
  const long long orow = static_cast<long long>(b) * mx;
  for (int j = tid; j < mx; j += threads) {
    const bool live = j < cnt;
    const int is = a.ins_seq[row + j], rs = a.rem_seq[row + j];
    const int d_ins = live && is != kUnassigned ? wrap_sub(is, base_ins) : -1;
    const bool real = live && rs != kNoRemove && rs != kUnassigned;
    const int d_rem = real ? wrap_sub(rs, base_rem)
                           : (live && rs == kUnassigned ? -2 : -1);
    ok = ok && in_range(live ? d_ins : 0) && in_range(live ? d_rem : 0);
    const long long o = orow + j;
    a.stacked16[o] = n16(live ? a.length[row + j] : 0);
    a.stacked16[plane + o] = n16(live ? a.origin_off[row + j] : 0);
    a.stacked16[2 * plane + o] = n16(live ? a.ins_client[row + j] : -1);
    a.stacked16[3 * plane + o] = n16(live ? a.rem_client[row + j] : -1);
    a.stacked16[4 * plane + o] = n16(d_ins);
    a.stacked16[5 * plane + o] = n16(d_rem);
    a.op32[o] = a.origin_op[row + j];
  }
  for (int e = tid; e < mx * A; e += threads) {
    const int v = a.anno[arow + e];
    const bool on = e / A < cnt && v >= 0;
    const int d = on ? wrap_sub(v, base_anno) : -1;
    ok = ok && in_range(on ? d : 0);
    a.anno16[orow * A + e] = n16(d);
  }
  ok = __syncthreads_and(ok) != 0;
  if (tid == 0) {
    a.meta[b] = base_ins;
    a.meta[B + b] = base_rem;
    a.meta[2 * B + b] = base_anno;
    a.meta[3 * B + b] = ok ? 1 : 0;
  }
}

}  // namespace

// ptrs, in order: the packed rows in (origin_op, origin_off, length, anno,
// ins_seq, ins_client, rem_seq, rem_client, counts) and the wire out
// (stacked16, anno16, op32, meta). `capacity` is the packed planes' width
// C, `mx` the slice taken of it. A shape the kernel does not take (B or C
// below 1, mx outside 1..C, A below 0) is refused with
// cudaErrorInvalidValue and nothing runs. Returns cudaGetLastError.
extern "C" int fluid_narrow_pack(void** ptrs, int batch, int capacity,
                                 int mx, int a_slots, void* stream) {
  if (batch < 1 || capacity < 1 || mx < 1 || mx > capacity || a_slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NarrowArgs a;
  a.origin_op = static_cast<const int*>(ptrs[0]);
  a.origin_off = static_cast<const int*>(ptrs[1]);
  a.length = static_cast<const int*>(ptrs[2]);
  a.anno = static_cast<const int*>(ptrs[3]);
  a.ins_seq = static_cast<const int*>(ptrs[4]);
  a.ins_client = static_cast<const int*>(ptrs[5]);
  a.rem_seq = static_cast<const int*>(ptrs[6]);
  a.rem_client = static_cast<const int*>(ptrs[7]);
  a.counts = static_cast<const int*>(ptrs[8]);
  a.stacked16 = static_cast<short*>(ptrs[9]);
  a.anno16 = static_cast<short*>(ptrs[10]);
  a.op32 = static_cast<int*>(ptrs[11]);
  a.meta = static_cast<int*>(ptrs[12]);
  a.batch = batch;
  a.capacity = capacity;
  a.mx = mx;
  a.a_slots = a_slots;
  const int rounded = (mx + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  narrow_pack_kernel<<<batch, threads, 3 * kMaxWarps * sizeof(int), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
