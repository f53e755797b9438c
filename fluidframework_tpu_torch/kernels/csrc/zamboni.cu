// Zamboni: the left-pack of the segment rows not yet freed, over [B, C]
// tables, in three modes of one kernel on three paths.
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
// Design. The unit of work is a strip of 32 rows, one a lane: the keep
//   mask is the strip's __ballot_sync, a kept row's destination the
//   running base plus the __popc of the mask below its lane, so the
//   destinations are unique, in order, and contiguous for the strip.
//   Every plane's loads for a strip are issued before its stores. The
//   rows' K rem_clients and A anno slots move as the contiguous [32, K]
//   and [32, A] spans they are: lane l takes flat unit u = 32 j + l of the
//   span, whose row is u / K and whose keep bit and destination come from
//   the mask (a warp's loads and stores are then coalesced), in 16-byte
//   units where A % 4 == 0 and both anno pointers are 16-byte aligned.
//   The padding past the new count is written in 16-byte stores between a
//   scalar head and tail. Three paths, chosen by
//   mergetree/kernel.zamboni_geometry from measurements on the H100
//   (PERF.md §6):
//   - warp: a warp a document, docs_per_block documents a block, for the
//     fleets (many short documents). The warp walks its live prefix (the
//     rows below min(count, C); none past it can be kept) strip by strip,
//     the base in a register, the first strip's rem_seq loaded beside the
//     count and each next one ahead of its strip; no block barrier.
//   - block: a block a document (the first design's geometry: min(256, C
//     rounded up to 32) threads), a tile of one strip a warp, the warps'
//     totals through shared memory between two __syncthreads a tile.
//   - cluster: a thread-block cluster of `ranks` blocks a document, for
//     wide tables in small batches. The live prefix is cut into ranks x
//     warps contiguous chunks of whole strips, rank r holding chunks [r W,
//     (r + 1) W). Pass 1 counts each warp's keeps from rem_seq alone and
//     publishes them in its block's shared memory; after one cluster
//     barrier every warp sums the totals before it (and all of them: the
//     new count) through map_shared_rank; pass 2 is the strip scan and
//     scatter from that base; the cluster's threads split the padding; a
//     last cluster barrier keeps any block from leaving while another may
//     still read its shared memory.
//   Out of place: the input is never written (the lane store keeps its
//   pre-compaction state until it adopts the result). Every kernel is
//   bounded to kMaxThreads threads a block (chip_smoke.py refuses any stack
//   or spill in the -Xptxas -v report).

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 256;  // the block path's most threads
// A block's most threads: ptxas gives the compacting modes 128 registers a
// thread under __launch_bounds__(512) with no spill on sm_90a (162-168
// with no bound, which no 512- or 1,024-thread block can hold; bounded to
// 64 or 80 registers they spill: the -Xptxas -v report, PERF.md §6).
constexpr int kMaxThreads = 512;
constexpr int kMaxRanks = 16;  // 8 portable; 16 non-portable
constexpr int kUnassigned = 0x7fffffff;  // DEV_UNASSIGNED
constexpr int kNoRemove = 0x7ffffffe;    // DEV_NO_REMOVE
enum { kCompact = 0, kCompactExtract = 1, kExtract = 2 };
enum { kWarp = 0, kBlock = 1, kCluster = 2 };

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
  int batch;
  int capacity;
  int k_slots;
  int a_slots;
  int a_vec;  // the anno span moves in 16-byte units
  int ranks;
  int docs_per_block;
};

// A lane's walk over a strip's span of `units` units a row: the row and
// slot of its unit `lane`, and what a step of 32 units adds to them.
struct Walk {
  int units, r, k, dr, dk;
};

__device__ __forceinline__ Walk walk(int units, int lane) {
  Walk w{units, 0, 0, 0, 0};
  if (units > 0) {
    w.r = lane / units;
    w.k = lane - w.r * units;
    w.dr = 32 / units;
    w.dk = 32 - w.dr * units;
  }
  return w;
}

// (r, k) one step of 32 units on.
__device__ __forceinline__ void advance(const Walk& w, int& r, int& k) {
  r += w.dr;
  k += w.dk;
  if (k >= w.units) {
    k -= w.units;
    ++r;
  }
}

// A batch of a lane's span units between their loads and their stores:
// 16 bytes of them (four ints or one int4), and which were loaded.
template <class T>
struct Span {
  static constexpr int kBatch = 16 / sizeof(T);
  T v[kBatch];
  unsigned kept;  // bit j: unit j's row is kept (v[j] loaded)
};

// Load the lane's units j0 + 32 j + lane (j < Span<T>::kBatch) of the
// strip's span whose rows the mask keeps; (r, k): the row and slot of unit
// j0 + lane.
template <class T>
__device__ __forceinline__ void load_span(Span<T>& sp, const int* src,
                                          long long s0, const Walk& w,
                                          int r, int k, unsigned m, int j0,
                                          int lane) {
  const T* p = reinterpret_cast<const T*>(src) + s0 * w.units;
  const int total = 32 * w.units;
  sp.kept = 0;
#pragma unroll
  for (int j = 0; j < Span<T>::kBatch; ++j) {
    const int u = j0 + 32 * j + lane;
    if (u < total && ((m >> r) & 1u)) {
      sp.kept |= 1u << j;
      sp.v[j] = p[u];
    }
    advance(w, r, k);
  }
}

// Store the loaded units: unit (r, k) of a kept row goes to slot k of the
// row's destination, the __popc of the mask below r.
template <class T>
__device__ __forceinline__ void store_span(const Span<T>& sp, int* dst,
                                           long long t0, const Walk& w,
                                           int r, int k, unsigned m) {
  T* p = reinterpret_cast<T*>(dst) + t0 * w.units;
#pragma unroll
  for (int j = 0; j < Span<T>::kBatch; ++j) {
    if ((sp.kept >> j) & 1u)
      p[__popc(m & ((1u << r) - 1u)) * w.units + k] = sp.v[j];
    advance(w, r, k);
  }
}

// The span units past the first batch (more than Span<T>::kBatch a row).
template <class T>
__device__ __forceinline__ void move_span_rest(const int* src, int* dst,
                                               long long s0, long long t0,
                                               const Walk& w, unsigned m,
                                               int lane) {
  constexpr int kStep = 32 * Span<T>::kBatch;
  int r = w.r, k = w.k;
  for (int j = 0; j < Span<T>::kBatch; ++j) advance(w, r, k);
  for (int j0 = kStep; j0 < 32 * w.units; j0 += kStep) {
    Span<T> sp;
    load_span(sp, src, s0, w, r, k, m, j0, lane);
    store_span(sp, dst, t0, w, r, k, m);
    for (int j = 0; j < Span<T>::kBatch; ++j) advance(w, r, k);
  }
}

// One strip [r0, r0 + 32) of the document whose first row is `row`: the
// rows the mask m keeps (rs: the lane's rem_seq) go to base, base + 1, ...
// wk, wa: the lane's walks over the K and A spans (wa in TA units).
template <int kMode, class TA>
__device__ __forceinline__ void scatter_strip(const ZamboniArgs& a,
                                              const Walk& wk, const Walk& wa,
                                              long long row, int r0, int rs,
                                              unsigned m, int base,
                                              int lane) {
  const bool keep = (m >> lane) & 1u;
  const long long s0 = row + r0, t0 = row + base;
  const long long s = s0 + lane;
  const long long t = t0 + __popc(m & ((1u << lane) - 1u));
  const int K = a.k_slots;
  int v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0, v5 = 0, v6 = 0, rc = 0;
  Span<int> sk;
  Span<TA> sa;
  if (kMode != kExtract) {
    if (keep) {
      v0 = a.length[s];
      v1 = a.ins_seq[s];
      v2 = a.ins_client[s];
      v3 = a.local_seq[s];
      v4 = a.rem_local_seq[s];
      v5 = a.origin_op[s];
      v6 = a.origin_off[s];
      if (kMode == kCompactExtract) rc = a.rem_clients[s * K];
    }
    load_span(sk, a.rem_clients, s0, wk, wk.r, wk.k, m, 0, lane);
    load_span(sa, a.anno, s0, wa, wa.r, wa.k, m, 0, lane);
    if (keep) {
      a.c_length[t] = v0;
      a.c_ins_seq[t] = v1;
      a.c_ins_client[t] = v2;
      a.c_local_seq[t] = v3;
      a.c_rem_seq[t] = rs;
      a.c_rem_local_seq[t] = v4;
      a.c_origin_op[t] = v5;
      a.c_origin_off[t] = v6;
      if (kMode == kCompactExtract) a.x_rem_client[t] = rc;
    }
    store_span(sk, a.c_rem_clients, t0, wk, wk.r, wk.k, m);
    store_span(sa, a.c_anno, t0, wa, wa.r, wa.k, m);
    if (wk.units > Span<int>::kBatch)
      move_span_rest<int>(a.rem_clients, a.c_rem_clients, s0, t0, wk, m,
                          lane);
    if (wa.units > Span<TA>::kBatch)
      move_span_rest<TA>(a.anno, a.c_anno, s0, t0, wa, m, lane);
  } else {
    if (keep) {
      v0 = a.origin_op[s];
      v1 = a.origin_off[s];
      v2 = a.length[s];
      v3 = a.ins_seq[s];
      v4 = a.ins_client[s];
      rc = a.rem_clients[s * K];
    }
    load_span(sa, a.anno, s0, wa, wa.r, wa.k, m, 0, lane);
    if (keep) {
      a.x_origin_op[t] = v0;
      a.x_origin_off[t] = v1;
      a.x_length[t] = v2;
      a.x_ins_seq[t] = v3;
      a.x_ins_client[t] = v4;
      a.x_rem_seq[t] = rs;
      a.x_rem_client[t] = rc;
    }
    store_span(sa, a.x_anno, t0, wa, wa.r, wa.k, m);
    if (wa.units > Span<TA>::kBatch)
      move_span_rest<TA>(a.anno, a.x_anno, s0, t0, wa, m, lane);
  }
}

// A lane's walks over the K span (in ints; none when extracting) and the
// A span (in int4s where a_vec, else ints).
struct Walks {
  Walk k, a;
};

template <int kMode>
__device__ __forceinline__ Walks walks(const ZamboniArgs& a, int lane) {
  return {walk(kMode != kExtract ? a.k_slots : 0, lane),
          walk(a.a_vec ? a.a_slots >> 2 : a.a_slots, lane)};
}

// The strip, by the anno span's unit.
template <int kMode>
__device__ __forceinline__ void strip(const ZamboniArgs& a, const Walks& w,
                                      long long row, int r0, int rs,
                                      unsigned m, int base, int lane) {
  if (a.a_vec)
    scatter_strip<kMode, int4>(a, w.k, w.a, row, r0, rs, m, base, lane);
  else
    scatter_strip<kMode, int>(a, w.k, w.a, row, r0, rs, m, base, lane);
}

// v into p[lo, hi): thread g of G, 16-byte stores between a scalar head
// (up to the first 16-byte boundary) and tail.
__device__ __forceinline__ void fill(int* p, long long lo, long long hi,
                                     int v, int g, int G) {
  if (lo >= hi) return;
  int* b = p + lo;
  const long long n = hi - lo;
  long long head =
      static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(b) & 15)) &
                             15) >> 2;
  if (head > n) head = n;
  for (long long i = g; i < head; i += G) b[i] = v;
  int4* vb = reinterpret_cast<int4*>(b + head);
  const long long nv = (n - head) >> 2;
  const int4 vv = make_int4(v, v, v, v);
  for (long long i = g; i < nv; i += G) vb[i] = vv;
  for (long long i = head + nv * 4 + g; i < n; i += G) b[i] = v;
}

// Rows [lo, hi) of a span of `units` T units a row each take the units of
// row `last`: thread g of G.
template <class T>
__device__ __forceinline__ void fill_rows(T* p, const T* last, int units,
                                          long long lo, long long hi, int g,
                                          int G) {
  if (units == 1) {
    const T v = last[0];
    for (long long i = lo + g; i < hi; i += G) p[i] = v;
    return;
  }
  for (long long u = lo * units + g; u < hi * units; u += G)
    p[u] = last[u % units];
}

// Slots [n, C) of the document whose first row is `row`: make_state's
// blanks when compacting, the input's last row when extracting. Thread g
// of G.
template <int kMode>
__device__ __forceinline__ void pad_doc(const ZamboniArgs& a, long long row,
                                        int n, int g, int G) {
  const long long lo = row + n, hi = row + a.capacity;
  const int K = a.k_slots, A = a.a_slots;
  if (lo >= hi) return;
  if (kMode != kExtract) {
    fill(a.c_length, lo, hi, 0, g, G);
    fill(a.c_ins_seq, lo, hi, kUnassigned, g, G);
    fill(a.c_ins_client, lo, hi, -1, g, G);
    fill(a.c_local_seq, lo, hi, 0, g, G);
    fill(a.c_rem_seq, lo, hi, kNoRemove, g, G);
    fill(a.c_rem_local_seq, lo, hi, 0, g, G);
    fill(a.c_origin_op, lo, hi, -1, g, G);
    fill(a.c_origin_off, lo, hi, 0, g, G);
    fill(a.c_rem_clients, lo * K, hi * K, -1, g, G);
    fill(a.c_anno, lo * A, hi * A, -1, g, G);
    if (kMode == kCompactExtract) fill(a.x_rem_client, lo, hi, -1, g, G);
  } else {
    const long long last = hi - 1;
    fill(a.x_origin_op, lo, hi, a.origin_op[last], g, G);
    fill(a.x_origin_off, lo, hi, a.origin_off[last], g, G);
    fill(a.x_length, lo, hi, a.length[last], g, G);
    fill(a.x_ins_seq, lo, hi, a.ins_seq[last], g, G);
    fill(a.x_ins_client, lo, hi, a.ins_client[last], g, G);
    fill(a.x_rem_seq, lo, hi, a.rem_seq[last], g, G);
    fill(a.x_rem_client, lo, hi, a.rem_clients[last * K], g, G);
    if (A == 0) return;
    if (a.a_vec) {
      const int u = A >> 2;
      fill_rows(reinterpret_cast<int4*>(a.x_anno),
                reinterpret_cast<const int4*>(a.anno) + last * u, u, lo, hi,
                g, G);
    } else {
      fill_rows(a.x_anno, a.anno + last * A, A, lo, hi, g, G);
    }
  }
}

// The new count, and the pre-compaction count when asked for.
template <int kMode>
__device__ __forceinline__ void finish(const ZamboniArgs& a, int b, int n,
                                       int cnt) {
  if (kMode != kExtract) a.c_count[b] = n;
  if (kMode == kExtract) a.x_count[b] = n;
  if (a.pre_count != nullptr) a.pre_count[b] = cnt;
}

__device__ __forceinline__ int live_rows(int cnt, int cap) {
  return cnt < 0 ? 0 : min(cnt, cap);
}

// rem_seq of row i when i < hi (0 otherwise: not read, not kept).
__device__ __forceinline__ int rem_at(const ZamboniArgs& a, long long row,
                                      int i, int hi) {
  return i < hi ? a.rem_seq[row + i] : 0;
}

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
zamboni_kernel_warp(ZamboniArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * a.docs_per_block + (threadIdx.x >> 5);
  if (b >= a.batch) return;  // a whole warp: no block barrier follows
  const int cap = a.capacity;
  const long long row = static_cast<long long>(b) * cap;
  const int cnt = a.count[b];
  const int mseq = a.min_seq[b];
  int rs = rem_at(a, row, lane, cap);  // issued beside count's load
  const int live = live_rows(cnt, cap);
  const Walks w = walks<kMode>(a, lane);
  int base = 0;
  for (int r0 = 0; r0 < live; r0 += 32) {
    const int next = rem_at(a, row, r0 + 32 + lane, live);
    const unsigned m =
        __ballot_sync(kFull, r0 + lane < live && !(rs <= mseq));
    if (m != 0) strip<kMode>(a, w, row, r0, rs, m, base, lane);
    base += __popc(m);
    rs = next;
  }
  pad_doc<kMode>(a, row, base, lane, 32);
  if (lane == 0) finish<kMode>(a, b, base, cnt);
}

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
zamboni_kernel_block(ZamboniArgs a) {
  extern __shared__ int smem[];  // the warps' keep totals of a tile
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int cap = a.capacity;
  const long long row = static_cast<long long>(b) * cap;
  const int cnt = a.count[b];
  const int mseq = a.min_seq[b];
  const int live = live_rows(cnt, cap);  // uniform per block
  const Walks w = walks<kMode>(a, lane);
  int base = 0;
  for (int t0 = 0; t0 < live; t0 += threads) {
    const int r0 = t0 + warp * 32;
    const int rs = rem_at(a, row, r0 + lane, live);
    const unsigned m =
        __ballot_sync(kFull, r0 + lane < live && !(rs <= mseq));
    if (lane == 0) smem[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int q = 0; q < warps; ++q) {
      const int v = smem[q];
      before += q < warp ? v : 0;
      total += v;
    }
    __syncthreads();  // every total read before the next tile writes them
    if (m != 0) strip<kMode>(a, w, row, r0, rs, m, base + before, lane);
    base += total;
  }
  pad_doc<kMode>(a, row, base, tid, threads);
  if (tid == 0) finish<kMode>(a, b, base, cnt);
}

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
zamboni_kernel_cluster(ZamboniArgs a) {
  extern __shared__ int smem[];  // this block's warps' keep totals
  const cg::cluster_group cl = cg::this_cluster();
  const int n = a.ranks;
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int cap = a.capacity;
  const long long row = static_cast<long long>(b) * cap;
  const int cnt = a.count[b];
  const int mseq = a.min_seq[b];
  const int live = live_rows(cnt, cap);
  // warp g of the cluster's parts takes rows [lo, hi): whole strips
  const int parts = n * warps, g = rank * warps + warp;
  const int chunk = ((live + parts - 1) / parts + 31) & ~31;
  const int lo = min(g * chunk, live), hi = min(lo + chunk, live);
  int mine = 0;
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int rs = rem_at(a, row, r0 + lane, hi);
    mine += __popc(__ballot_sync(kFull, r0 + lane < hi && !(rs <= mseq)));
  }
  if (lane == 0) smem[warp] = mine;
  cl.sync();  // every warp's total published
  unsigned before = 0, total = 0;
  for (int q = lane; q < parts; q += 32) {
    const unsigned v = static_cast<unsigned>(
        *cl.map_shared_rank(smem + q % warps, q / warps));
    total += v;
    before += q < g ? v : 0u;
  }
  int base = static_cast<int>(__reduce_add_sync(kFull, before));
  const int kept = static_cast<int>(__reduce_add_sync(kFull, total));
  const Walks w = walks<kMode>(a, lane);
  int rs = rem_at(a, row, lo + lane, hi);
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int next = rem_at(a, row, r0 + 32 + lane, hi);
    const unsigned m = __ballot_sync(kFull, r0 + lane < hi && !(rs <= mseq));
    if (m != 0) strip<kMode>(a, w, row, r0, rs, m, base, lane);
    base += __popc(m);
    rs = next;
  }
  pad_doc<kMode>(a, row, kept, rank * blockDim.x + tid, n * blockDim.x);
  if (rank == 0 && tid == 0) finish<kMode>(a, b, kept, cnt);
  cl.sync();  // no block leaves while another may still read its memory
}

typedef void (*ZamboniKernel)(ZamboniArgs);

template <int kMode>
ZamboniKernel kernel_of(int path) {
  return path == kWarp    ? &zamboni_kernel_warp<kMode>
         : path == kBlock ? &zamboni_kernel_block<kMode>
                          : &zamboni_kernel_cluster<kMode>;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether this geometry is one the path takes (mergetree/kernel.py
// zamboni_geometry and _forced_zamboni_geometry make only these):
// - warp: one block of docs_per_block warps (1..16), a warp a document;
// - block: one block a document of min(256, C rounded up to 32) threads;
// - cluster: 2..16 blocks a document, 32..512 threads a block, a multiple
//   of 32.
bool geometry_ok(int path, int capacity, int ranks, int threads,
                 int docs_per_block) {
  const int rounded = (capacity + 31) / 32 * 32;
  switch (path) {
    case kWarp:
      return ranks == 1 && docs_per_block >= 1 &&
             docs_per_block <= kMaxThreads / 32 &&
             threads == 32 * docs_per_block;
    case kBlock:
      return ranks == 1 && docs_per_block == 1 &&
             threads == (rounded < kBlockThreads ? rounded : kBlockThreads);
    case kCluster:
      return ranks >= 2 && ranks <= kMaxRanks && docs_per_block == 1 &&
             threads % 32 == 0 && threads >= 32 && threads <= kMaxThreads;
    default:
      return false;
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
// mode: 0 compact, 1 compact + extract, 2 extract. path: 0 warp, 1 block,
// 2 cluster, with its ranks (blocks a document), threads a block and
// documents a block. A mode, shape or geometry the kernel does not take (B,
// C or K below 1, A below 0, a geometry geometry_ok refuses) is refused
// with cudaErrorInvalidValue and nothing runs. Returns the launch's error.
extern "C" int fluid_zamboni(void** ptrs, int mode, int batch, int capacity,
                             int k_slots, int a_slots, int path, int ranks,
                             int threads, int docs_per_block, void* stream) {
  if (mode < kCompact || mode > kExtract || batch < 1 || capacity < 1 ||
      k_slots < 1 || a_slots < 0 ||
      !geometry_ok(path, capacity, ranks, threads, docs_per_block))
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
  a.batch = batch;
  a.capacity = capacity;
  a.k_slots = k_slots;
  a.a_slots = a_slots;
  a.a_vec = a_slots > 0 && a_slots % 4 == 0 && aligned16(a.anno) &&
            aligned16(mode == kExtract ? a.x_anno : a.c_anno);
  a.ranks = ranks;
  a.docs_per_block = docs_per_block;
  const ZamboniKernel kern = mode == kCompact ? kernel_of<kCompact>(path)
      : mode == kCompactExtract ? kernel_of<kCompactExtract>(path)
                                : kernel_of<kExtract>(path);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = path == kWarp ? 0 : (threads / 32) * sizeof(int);
  if (path != kCluster) {
    const int grid = path == kWarp
        ? (batch + docs_per_block - 1) / docs_per_block : batch;
    kern<<<grid, threads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (ranks > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * ranks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
