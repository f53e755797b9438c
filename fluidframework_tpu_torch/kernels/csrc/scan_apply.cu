// The scan apply: the op stream of each document applied to its segment
// table, for tables of any capacity.
//
// Replaces: fluidframework_tpu/mergetree/kernel.py:396-442 _scan_ops, the
//   lax.scan of apply_one over the op columns (XLA, not Pallas), behind
//   apply_ops, apply_ops_batched, apply_ops_keep(runs=) and
//   apply_ops_batched_keep, in both of its variants: plain (runs=None) and
//   INSERT_RUN (runs=, kernel.py:192-249). A single-document call is a
//   batch of one. What it computes is apply_one for op t = 0..T-1 of every
//   document: the capacity gate (count + 2 <= C; count + RUN_K + 1 for a
//   run), boundary splits at pos1 (and pos2 for ranges), then insert /
//   insert run / remove with overlap clients / annotate ring, then acks,
//   then seq / min_seq; every lane of the table (the padding past `count`
//   too), the overflow flag and the annotate ring end bit-identical to the
//   JAX result. The variant is a template parameter (kRuns).
//
// apply_one's phases compute the same function as the fused apply's
// _apply_one_batched (the JAX package holds the two bit-identical,
// tests/test_pallas_apply.py), so the per-slot rules and apply_one itself
// are fused_apply.cu's own, included below with FLUID_APPLY_RULES_ONLY;
// this file adds a document type (Live) with its own primitives, as the
// fused apply's Warp<kR> is one.
//
// Bound on the H100. Bytes: the state is read once and written once,
// (8 + K + A) int32 planes and four scalars per document, and the op and
// run columns are read once: about 2 MB at B = 1, C = 16,384, K = 3,
// A = 4, T = 512, or 0.6 us at 3.35 TB/s. Operations: every op costs the
// rows it touches about a hundred integer operations each (visibility and
// prefix sums, boundary tests, shifts of all planes; chip_smoke.py counts
// them from the run's data), about 1e8 at that shape over the rows in use,
// 6-12 us at the card's integer rate (16.7e12/s). A document's ops are a
// chain of dependent steps, and one document runs on the SMs of its block
// or cluster only, so what a launch of few documents costs is the chain:
// the passes per op, the length of each pass and the barriers that join
// its threads.
//
// Four paths, chosen per launch by the host (mergetree/kernel.
// scan_geometry, a fixed rule of (B, C, K, A) measured on the H100 by
// calibrate_fused_apply.py --scan); this file checks the geometry it is
// given against its own formulas and refuses a mismatch with
// cudaErrorInvalidValue:
// - smem: one block per document, the table and the per-op view planes
//   (prefix sum, visibility) in its shared memory: (P + 2) x C ints, P =
//   8 + K + A, plus scratch, up to 227 KB (C <= 3,410 at P = 15).
// - cluster: a thread-block cluster of n blocks per document (n <= 8
//   portable, 16 with the non-portable attribute); rank r holds the slots
//   [r Cs, (r + 1) Cs), Cs = ceil(C / n), of every plane in its own shared
//   memory. Prefix-sum carries and reductions cross blocks through
//   distributed shared memory (each block publishes its totals, one
//   barrier.cluster, every block reads all of them); a shift's first kBy
//   slots of a rank read the rank below before the cluster barrier that
//   lets any rank write.
// - global: one block per document, the table in a [B, P, C] work buffer
//   in device memory (it stays in the 50 MB L2 at the catch-up's shapes),
//   the view planes in shared memory up to kMaxSharedSlots and in a
//   [B, 2, C] device buffer above: for tables that fit no cluster (C =
//   65,536, annotate rings doubled up to 512 on a retry).
// - global_chunked: the first design, kept to measure the others against:
//   fused_apply.cu's BLOCK path on the device-memory work buffer, one
//   thread per slot in 512-slot chunks, every pass over all C slots, the
//   view computed three times per range op.
// Every path but global_chunked:
// - Sweeps cut at the live rows. No op writes a slot at or past count but
//   an ack, which treats identical slots identically, and a shift, which
//   moves padding onto padding; so when every plane's padding holds one
//   value on entry (checked once per document, with 0 <= count <= C), it
//   holds one value after every op: a view pass or a stop test covers
//   [0, count + 1), a range test [0, count), a shift [lo, count + kBy)
//   (one slot more where it moves the view), and an ack reaches the
//   padding exactly when it reaches its first slot. A document whose
//   padding differs sweeps the whole table, as JAX does.
// - One view pass per op. The vis / cum planes are computed once per op,
//   at (ref_seq, client), fused with the pos1 boundary test; a boundary
//   split moves them with the table (the new slot s + 1 keeps vis[s] and
//   takes cum = pos; the slots above keep theirs), so the pos2 split and
//   the phase read them as they are. They are scratch: the state written
//   out is the same.
// - Passes of many slots per thread. A pass over [lo, e) gives each thread
//   a strip of ceil((e - lo) / threads) slots rounded up to an odd number
//   (a warp's 32 strips then fall in 32 banks), done serially in registers,
//   then one block combine (and one cluster combine): 1 barrier per
//   combine whatever C is (the partials are double-buffered by parity;
//   each warp reduces them with __reduce_*_sync, a lane per warp or per
//   rank). A shift moves one slot per thread per round, kShiftPlanes
//   planes at a time.
// - The table is loaded with cp.async (smem and cluster) or plain loads
//   (global) and written back from where it lives; the input state is never
//   written (the _keep semantics: an overflow retry re-applies from it).
// - Any A >= 1 and 1 <= K <= 8; P x C < 2^31.

#define FLUID_APPLY_RULES_ONLY
#include "fused_apply.cu"
#undef FLUID_APPLY_RULES_ONLY

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kSmemLimit = 232448;  // shared memory per block on Hopper
constexpr int kScanThreads = 512;   // threads per block, at most
// Live paths' shared scratch: 2 x 96 per-warp partials, 2 x 4 cluster
// totals (each double-buffered by combine parity).
constexpr int kLiveScratch = 200;
// The largest C whose view planes (2 x C ints) fit a block's shared memory
// beside the scratch, on the device-memory paths.
constexpr int kMaxSharedSlots =
    (kSmemLimit - kLiveScratch * static_cast<int>(sizeof(int))) /
    (2 * static_cast<int>(sizeof(int)));
constexpr int kMaxCluster = 16;
constexpr int kMinNone = 0x7fffffff;  // the identity of a min reduction
constexpr int kShiftPlanes = 17;  // planes staged at once (P + 2 at K3 A4)

enum ScanPath { SCAN_GLOBAL_CHUNKED = 0, SCAN_GLOBAL = 1, SCAN_SMEM = 2,
                SCAN_CLUSTER = 3 };  // mergetree/kernel._SCAN_PATHS

struct ScanArgs {
  Args a;
  int* work;     // [B, P, C] planar table (global paths), else null
  int* scratch;  // [B, 2, C] view planes in device memory, or null
};

// ---------------------------------------------------------------------------
// global_chunked: the block path on a table in device memory
// ---------------------------------------------------------------------------

// Thread tid of nthr copies its share of one document's input state into
// the planar table W (slot l of plane p at W[p * C + l]). cp.async writes
// only shared memory, so these are plain loads and stores; the
// interleaved [C, n] planes (rem_clients, anno) are read in order.
__device__ void load_table_global(int* W, const Args& a, long long doc,
                                  int tid, int nthr) {
  const int C = a.capacity, K = a.k_slots, A = a.a_slots;
  const long long row = doc * C;
  for (int p = 0; p < SEG_PLANES; ++p)
    for (int l = tid; l < C; l += nthr)
      W[p * C + l] = __ldg(a.in_seg[p] + row + l);
  for (int e = tid; e < C * K; e += nthr)
    W[(SEG_PLANES + e % K) * C + e / K] = __ldg(a.in_rc + row * K + e);
  for (int e = tid; e < C * A; e += nthr)
    W[(SEG_PLANES + K + e % A) * C + e / A] = __ldg(a.in_anno + row * A + e);
}

__device__ __forceinline__ Op load_op(const Args& a, long long at) {
  Op op;
  op.kind = __ldg(a.op[F_KIND] + at);
  op.seq = __ldg(a.op[F_SEQ] + at);
  op.ref_seq = __ldg(a.op[F_REF_SEQ] + at);
  op.client = __ldg(a.op[F_CLIENT] + at);
  op.pos1 = __ldg(a.op[F_POS1] + at);
  op.pos2 = __ldg(a.op[F_POS2] + at);
  op.op_id = __ldg(a.op[F_OP_ID] + at);
  op.new_len = __ldg(a.op[F_NEW_LEN] + at);
  op.local_seq = __ldg(a.op[F_LOCAL_SEQ] + at);
  op.msn = __ldg(a.op[F_MSN] + at);
  return op;
}

template <bool kRuns>
__global__ void __launch_bounds__(kScanThreads) scan_apply_kernel_chunked(
    ScanArgs s) {
  extern __shared__ int smem[];
  const Args& a = s.a;
  Blk b;
  b.C = a.capacity;
  b.K = a.k_slots;
  b.A = a.a_slots;
  b.P = SEG_PLANES + a.k_slots + a.a_slots;
  b.nthr = blockDim.x;
  b.tid = threadIdx.x;
  b.warp = threadIdx.x >> 5;
  b.lane = threadIdx.x & 31;
  b.nwarps = blockDim.x >> 5;
  const long long doc = blockIdx.x;
  b.S = s.work + doc * b.P * b.C;
  b.red = smem;
  b.scan = smem + 96;
  b.cum = s.scratch ? s.scratch + doc * 2 * b.C : smem + kScratchInts;
  b.vis = b.cum + b.C;

  int count = a.in_count[doc];
  int min_seq = a.in_min_seq[doc];
  int seq = a.in_seq[doc];
  bool overflow = a.in_overflow[doc] != 0;
  load_table_global(b.S, a, doc, b.tid, b.nthr);
  __syncthreads();

  const long long orow = doc * a.steps;
  for (int t = 0; t < a.steps; ++t)
    apply_one<kRuns>(b, a, (orow + t) * kRunK, load_op(a, orow + t), count,
                     min_seq, seq, overflow);
  __syncthreads();

  store_table(b.S, b.C, a, doc, b.tid, b.nthr);
  if (b.tid == 0) {
    a.out_count[doc] = count;
    a.out_min_seq[doc] = min_seq;
    a.out_seq[doc] = seq;
    a.out_overflow[doc] = overflow ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// the live paths: global, smem and cluster
// ---------------------------------------------------------------------------

// One document on a live path, as one block's (or one cluster rank's) view
// of it. kMode is SCAN_GLOBAL, SCAN_SMEM or SCAN_CLUSTER.
template <int kMode>
struct Live {
  static constexpr bool kCl = kMode == SCAN_CLUSTER;
  int* S;      // this rank's planes: slot lo + i of plane p at S[p*Cs + i]
  int* V;      // the view: cum at V[i], vis at V[Cs + i] (slot lo + i)
  int* red;    // [2][96] per-warp partials, by combine parity
  int* xred;   // [2][4] this block's totals, read by the whole cluster
  int* stage;  // [kRunK][P + 2] a shift's sources in lower ranks
  int C, K, A, P, Cs, lo, hi;  // this rank holds the slots [lo, hi)
  int nthr, tid, lane, warp, nwarps, rank, nrank;
  int par;         // parity of the next combine
  int vcount;      // count when apply_one last asked for the view
  bool exact_pad;  // 0 <= count <= C and each plane's slots >= count agree
  bool view_ok;    // V holds this op's view

  // Plane p of this rank: the table's P planes, then cum and vis.
  __device__ __forceinline__ int* plane(int p) const {
    return p < P ? S + p * Cs : V + (p - P) * Cs;
  }
  __device__ __forceinline__ Slot own(int l) const {
    return Slot{S + (l - lo), Cs};
  }
  __device__ __forceinline__ int& cum(int l) const { return V[l - lo]; }
  __device__ __forceinline__ int& vis(int l) const { return V[Cs + l - lo]; }
  __device__ __forceinline__ bool owns(int l) const {
    return l >= lo && l < hi;
  }
  // The slots [0, extent(end)) are all an op has to touch when count <= end
  // (see the file's header); else the whole table.
  __device__ __forceinline__ int extent(int end) const {
    return exact_pad ? min(end, C) : C;
  }
  // This thread's strip of this rank's part of [0, e): [a, b).
  __device__ __forceinline__ void strip(int e, int& a, int& b) const {
    const int top = min(hi, e);
    const int m = top - lo;
    if (m <= 0) {
      a = b = 0;
      return;
    }
    const int s = ((m + nthr - 1) / nthr) | 1;
    a = min(lo + tid * s, top);
    b = min(a + s, top);
  }
  __device__ __forceinline__ void cluster_sync() const {
    if constexpr (kCl) cg::this_cluster().sync();
  }
  // p in the shared memory of rank q (this block's layout).
  __device__ __forceinline__ int* remote(int* p, int q) const {
    if constexpr (kCl) return cg::this_cluster().map_shared_rank(p, q);
    return p;
  }
};

// Document-wide (min, sum, sum) of one value per thread; every thread of
// every rank gets the result. Each warp reduces, one block barrier, then
// every warp reduces the warps' partials, lane w taking warp w's; on a
// cluster, one cluster barrier, and lane q takes rank q's totals.
template <int kMode>
__device__ void combine(Live<kMode>& d, int& mn, unsigned& s1,
                        unsigned& s2) {
  mn = __reduce_min_sync(kFull, mn);
  s1 = __reduce_add_sync(kFull, s1);
  s2 = __reduce_add_sync(kFull, s2);
  int* r = d.red + d.par * 96;
  if (d.lane == 0) {
    r[d.warp] = mn;
    r[32 + d.warp] = static_cast<int>(s1);
    r[64 + d.warp] = static_cast<int>(s2);
  }
  __syncthreads();
  const bool w = d.lane < d.nwarps;
  mn = __reduce_min_sync(kFull, w ? r[d.lane] : kMinNone);
  s1 = __reduce_add_sync(kFull, w ? static_cast<unsigned>(r[32 + d.lane])
                                  : 0u);
  s2 = __reduce_add_sync(kFull, w ? static_cast<unsigned>(r[64 + d.lane])
                                  : 0u);
  if constexpr (Live<kMode>::kCl) {
    int* x = d.xred + d.par * 4;
    if (d.tid == 0) {
      x[0] = mn;
      x[1] = static_cast<int>(s1);
      x[2] = static_cast<int>(s2);
    }
    d.cluster_sync();
    const bool q = d.lane < d.nrank;
    const int* y = d.remote(x, q ? d.lane : 0);
    mn = __reduce_min_sync(kFull, q ? y[0] : kMinNone);
    s1 = __reduce_add_sync(kFull, q ? static_cast<unsigned>(y[1]) : 0u);
    s2 = __reduce_add_sync(kFull, q ? static_cast<unsigned>(y[2]) : 0u);
  }
  d.par ^= 1;
}

// Exclusive prefix sum of one value per thread in (rank, thread) order;
// total gets the document's sum. Barriers as combine's.
template <int kMode>
__device__ unsigned combine_scan(Live<kMode>& d, unsigned v,
                                 unsigned& total) {
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (d.lane >= o) x += y;
  }
  int* r = d.red + d.par * 96;
  if (d.lane == 31) r[d.warp] = static_cast<int>(x);
  __syncthreads();
  const unsigned w = d.lane < d.nwarps ? static_cast<unsigned>(r[d.lane])
                                       : 0u;
  unsigned before = __reduce_add_sync(kFull, d.lane < d.warp ? w : 0u);
  unsigned tot = __reduce_add_sync(kFull, w);
  if constexpr (Live<kMode>::kCl) {
    int* xs = d.xred + d.par * 4;
    if (d.tid == 0) xs[0] = static_cast<int>(tot);
    d.cluster_sync();
    const unsigned t = d.lane < d.nrank
        ? static_cast<unsigned>(d.remote(xs, d.lane)[0]) : 0u;
    before += __reduce_add_sync(kFull, d.lane < d.rank ? t : 0u);
    tot = __reduce_add_sync(kFull, t);
  }
  d.par ^= 1;
  total = tot;
  return before + x - v;
}

// The view at (ref, client) over [0, extent(count + 1)): vis (slots below
// count only) and the exclusive prefix sum of visible lengths. With kTest,
// the same pass finds the visible slot strictly containing pos (its slot,
// prefix sum and length, as this thread's share of a combine).
template <bool kTest, int kMode>
__device__ void compute_view(Live<kMode>& d, int ref, int client, int count,
                             int pos, int& mn, unsigned& scum,
                             unsigned& slen) {
  int a, b;
  d.strip(d.extent(count + 1), a, b);
  unsigned run = 0;
  for (int l = a; l < b; ++l) {
    const Slot s = d.own(l);
    const int v = l < count && slot_visible(s, d.K, ref, client);
    d.vis(l) = v;
    d.cum(l) = static_cast<int>(run);
    if (v) run += static_cast<unsigned>(s[LEN]);
  }
  unsigned total;
  const unsigned base = combine_scan(d, run, total);
  for (int l = a; l < b; ++l) {
    const int c = static_cast<int>(static_cast<unsigned>(d.cum(l)) + base);
    d.cum(l) = c;
    if (kTest && d.vis(l)) {
      const int len = d.own(l)[LEN];
      if (c < pos && pos < wadd(c, len) && l < mn) {
        mn = l;
        scum = static_cast<unsigned>(c);
        slen = static_cast<unsigned>(len);
      }
    }
  }
  d.view_ok = true;
}

// pallas_apply._visibility, once per op: apply_one asks for it after the
// boundaries, which computed it and kept it up to date.
template <int kMode>
__device__ void visibility(Live<kMode>& d, int ref, int client, int count) {
  d.vcount = count;
  if (d.view_ok) return;  // uniform
  int mn = d.C;
  unsigned s1 = 0, s2 = 0;
  compute_view<false>(d, ref, client, count, 0, mn, s1, s2);
}

// A boundary split's fix of the slot above it (slot < 0: none): the second
// half takes the rest of the length, its origin offset moves by off, and
// its prefix sum is pos.
struct SplitFix {
  int slot, off, len, pos;
};

__device__ __forceinline__ int split_fixed(const SplitFix& f, int P, int l,
                                           int p, int v) {
  if (l != f.slot + 1) return v;
  if (p == LEN) return wsub(f.len, f.off);
  if (p == ORIGIN_OFF) return wadd(v, f.off);
  if (p == P) return f.pos;  // cum
  return v;
}

// Slots l in [lo, hi) take slot l - kBy on every plane (and on the view's
// two with `view`); callers keep lo >= kBy. Then every thread runs fin(d)
// (writes of slots this rank holds that the shift read or left), and one
// block barrier. Cluster: where the range crosses a rank boundary, the
// dests of the first kBy slots of a rank read lower ranks into `stage`,
// and a cluster barrier lets every rank write after every rank read. The
// rest moves in rounds from the top down, each
// thread staging one slot's planes, kShiftPlanes at a time, in registers
// between two block barriers: a round's sources are read before the round
// below writes them.
template <int kBy, int kMode, class Fin>
__device__ void shift_right(Live<kMode>& d, int lo, int hi, bool view,
                            const SplitFix& f, Fin fin) {
  const int np = d.P + (view ? 2 : 0);
  const int a = max(lo, d.lo), b = min(hi, d.hi);  // this rank's dests
  int local = a;
  int ncross = 0;
  // Does a rank boundary fall in (lo - kBy, hi)? (uniform; if not, every
  // source lies in its dest's rank and no rank reads another's)
  if (Live<kMode>::kCl && ((lo - kBy) / d.Cs + 1) * d.Cs < hi) {
    ncross = max(0, min(b, d.lo + kBy) - a);
    for (int e = d.tid; e < ncross * np; e += d.nthr) {
      const int j = e / np, p = e % np;
      const int src = a + j - kBy;
      const int q = src / d.Cs;
      d.stage[e] = d.remote(d.plane(p), q)[src - q * d.Cs];
    }
    d.cluster_sync();
    local = a + ncross;
  }
  for (int top = b; top > local; top -= d.nthr) {  // uniform in the block
    const int l = max(local, top - d.nthr) + d.tid;
    for (int g = 0; g < np; g += kShiftPlanes) {
      int v[kShiftPlanes];
#pragma unroll
      for (int q = 0; q < kShiftPlanes; ++q)
        if (l < top && g + q < np) v[q] = d.plane(g + q)[l - kBy - d.lo];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kShiftPlanes; ++q)
        if (l < top && g + q < np)
          d.plane(g + q)[l - d.lo] = split_fixed(f, d.P, l, g + q, v[q]);
      __syncthreads();
    }
  }
  for (int e = d.tid; e < ncross * np; e += d.nthr) {
    const int j = e / np, p = e % np;
    d.plane(p)[a + j - d.lo] = split_fixed(f, d.P, a + j, p, d.stage[e]);
  }
  fin(d);
  __syncthreads();
}

// pallas_apply._ensure_boundary: split the visible segment strictly
// containing pos into [.., pos) and [pos, ..), keeping the view.
template <int kMode>
__device__ void ensure_boundary(Live<kMode>& d, int pos, int ref, int client,
                                int& count) {
  int mn = d.C;
  unsigned scum = 0, slen = 0;
  if (!d.view_ok) {  // uniform
    compute_view<true>(d, ref, client, count, pos, mn, scum, slen);
  } else {
    int a, b;
    d.strip(d.extent(count), a, b);
    for (int l = a; l < b; ++l) {
      if (!d.vis(l)) continue;
      const int c = d.cum(l);
      const int len = d.own(l)[LEN];
      if (c < pos && pos < wadd(c, len)) {
        mn = l;
        scum = static_cast<unsigned>(c);
        slen = static_cast<unsigned>(len);
        break;
      }
    }
  }
  combine(d, mn, scum, slen);
  if (mn >= d.C) return;  // no slot inside: nothing to split
  const SplitFix f{mn, wsub(pos, static_cast<int>(scum)),
                   static_cast<int>(slen), pos};
  shift_right<1>(d, f.slot + 1, d.extent(count + 2), true, f,
                 [&](Live<kMode>& e) {
                   if (e.tid == 0 && e.owns(f.slot))
                     e.own(f.slot)[LEN] = f.off;
                 });
  count += 1;
}

// First slot whose insert stop test holds, C if none (the whole document).
template <int kMode>
__device__ int first_stop(Live<kMode>& d, const Op& op, int count,
                          bool local_ok) {
  int a, b;
  d.strip(d.extent(count + 1), a, b);
  int mn = d.C;
  for (int l = a; l < b; ++l)
    if (insert_stop(d.own(l), d.vis(l), d.cum(l), l >= count, op,
                    local_ok)) {
      mn = l;
      break;
    }
  unsigned s1 = 0, s2 = 0;
  combine(d, mn, s1, s2);
  return mn;
}

// pallas_apply._insert_phase (the view is the post-boundary one). JAX
// rolls [slot, C) and refills slot on every plane; the shift starts at
// slot + 1.
template <int kMode>
__device__ void insert_phase(Live<kMode>& d, const Op& op, int& count,
                             bool& overflow) {
  const int slot = first_stop(d, op, count, op.seq == kUnassigned);
  if (slot >= d.C) {  // no tie-break slot: flagged, state unchanged
    overflow = true;
    return;
  }
  const SplitFix nofix{-2, 0, 0, 0};
  shift_right<1>(d, slot + 1, d.extent(count + 1), false, nofix,
                 [&](Live<kMode>& e) {
                   if (e.owns(slot))
                     for (int p = e.tid; p < e.P; p += e.nthr)
                       e.own(slot)[p] = insert_value(p, op);
                 });
  count += 1;
}

// pallas_apply._insert_run_phase: the members of run row `run` land as
// contiguous rows at the first member's tie-break slot.
template <int kMode>
__device__ void insert_run_phase(Live<kMode>& d, const Args& a, long long run,
                                 const Op& op, int& count, bool& overflow) {
  const int slot = first_stop(d, op, count, false);
  if (slot >= d.C) {  // no tie-break slot: flagged, state unchanged
    overflow = true;
    return;
  }
  const SplitFix nofix{-2, 0, 0, 0};
  shift_right<kRunK>(d, slot + kRunK, d.extent(count + kRunK), false, nofix,
                     [&](Live<kMode>& e) {
    for (int x = e.tid; x < kRunK * e.P; x += e.nthr) {
      const int rel = x % kRunK;
      const int p = x / kRunK;
      const int l = slot + rel;
      if (l >= e.C || !e.owns(l)) continue;
      e.own(l)[p] = run_value(p, __ldg(a.run_len + run + rel),
                              __ldg(a.run_seq + run + rel),
                              __ldg(a.run_id + run + rel), op.client);
    }
  });
  count += kRunK;
}

// pallas_apply._remove_phase: per slot, then one any-slot overflow vote.
template <int kMode>
__device__ void remove_phase(Live<kMode>& d, const Op& op, bool& overflow) {
  int a, b;
  d.strip(d.extent(d.vcount), a, b);  // targets are visible: below count
  unsigned over = 0;
  for (int l = a; l < b; ++l)
    if (d.vis(l) && range_target(d.own(l), true, d.cum(l), op))
      over |= remove_slot(d.own(l), d.K, op);
  int mn = 0;
  unsigned s2 = 0;
  combine(d, mn, over, s2);
  if (over) overflow = true;
}

// pallas_apply._annotate_phase: push op_id onto each target's ring.
template <int kMode>
__device__ void annotate_phase(Live<kMode>& d, const Op& op, bool& overflow) {
  int a, b;
  d.strip(d.extent(d.vcount), a, b);
  unsigned over = 0;
  for (int l = a; l < b; ++l)
    if (d.vis(l) && range_target(d.own(l), true, d.cum(l), op))
      over |= annotate_slot(d.own(l), d.K, d.A, op);
  int mn = 0;
  unsigned s2 = 0;
  combine(d, mn, over, s2);
  if (over) overflow = true;
}

// pallas_apply._ack_phase: every slot, padding included; with exact
// padding the first padding slot decides whether the ack reaches all of
// the padding or none of it.
template <int kMode>
__device__ void ack_phase(Live<kMode>& d, const Op& op, int count) {
  int n = d.extent(count);
  if (n < d.C) {  // uniform
    unsigned hit = 0;
    if (d.tid == 0 && d.owns(n)) {
      const Slot pad = d.own(n);
      hit = op.kind == ACK_INSERT
          ? pad[INS_SEQ] == kUnassigned && pad[LOCAL_SEQ] == op.local_seq
          : pad[REM_SEQ] == kUnassigned && pad[REM_LOCAL_SEQ] == op.local_seq;
    }
    int mn = 0;
    unsigned s2 = 0;
    combine(d, mn, hit, s2);  // every thread has read before any writes
    if (hit) n = d.C;
  }
  int a, b;
  d.strip(n, a, b);
  for (int l = a; l < b; ++l) ack_slot(d.own(l), op);
  __syncthreads();
}

// This rank's slots [lo, hi) of every plane, between the input (kLoad,
// cp.async, complete for this thread on return) or the output state and
// the planar shared-memory table S (plane stride Cs).
template <bool kLoad>
__device__ void copy_rows(int* S, int Cs, const Args& a, long long doc,
                          int lo, int hi, int tid, int nthr) {
  const int C = a.capacity, K = a.k_slots, A = a.a_slots;
  const long long row = doc * C;
  const int n = hi - lo;
  if (n <= 0) return;
  for (int p = 0; p < SEG_PLANES; ++p)
    for (int i = tid; i < n; i += nthr) {
      if constexpr (kLoad)
        __pipeline_memcpy_async(S + p * Cs + i, a.in_seg[p] + row + lo + i,
                                sizeof(int));
      else
        a.out_seg[p][row + lo + i] = S[p * Cs + i];
    }
  if constexpr (kLoad) {
    copy_interleaved<true>(S + SEG_PLANES * Cs, Cs,
                           a.in_rc + (row + lo) * K, n, K, tid, nthr);
    copy_interleaved<true>(S + (SEG_PLANES + K) * Cs, Cs,
                           a.in_anno + (row + lo) * A, n, A, tid, nthr);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    copy_interleaved<false>(S + SEG_PLANES * Cs, Cs,
                            a.out_rc + (row + lo) * K, n, K, tid, nthr);
    copy_interleaved<false>(S + (SEG_PLANES + K) * Cs, Cs,
                            a.out_anno + (row + lo) * A, n, A, tid, nthr);
  }
}

template <bool kRuns, int kMode>
__device__ __forceinline__ void live_body(const ScanArgs& s) {
  extern __shared__ int smem[];
  const Args& a = s.a;
  Live<kMode> d;
  d.C = a.capacity;
  d.K = a.k_slots;
  d.A = a.a_slots;
  d.P = SEG_PLANES + a.k_slots + a.a_slots;
  d.nthr = blockDim.x;
  d.tid = threadIdx.x;
  d.warp = threadIdx.x >> 5;
  d.lane = threadIdx.x & 31;
  d.nwarps = blockDim.x >> 5;
  d.par = 0;
  d.rank = 0;
  d.nrank = 1;
  if constexpr (Live<kMode>::kCl) {
    const cg::cluster_group cl = cg::this_cluster();
    d.rank = static_cast<int>(cl.block_rank());
    d.nrank = static_cast<int>(cl.num_blocks());
  }
  const long long doc = blockIdx.x / d.nrank;
  d.Cs = (d.C + d.nrank - 1) / d.nrank;
  d.lo = min(d.rank * d.Cs, d.C);
  d.hi = min(d.lo + d.Cs, d.C);
  if constexpr (kMode == SCAN_GLOBAL) {
    d.S = s.work + doc * d.P * d.C;
    d.red = smem;
    d.xred = smem + 192;
    d.stage = nullptr;
    d.V = s.scratch ? s.scratch + doc * 2 * d.C : smem + kLiveScratch;
    load_table_global(d.S, a, doc, d.tid, d.nthr);
  } else {
    d.S = smem;
    d.V = smem + d.P * d.Cs;
    d.red = d.V + 2 * d.Cs;
    d.xred = d.red + 192;
    d.stage = d.xred + 8;
    copy_rows<true>(d.S, d.Cs, a, doc, d.lo, d.hi, d.tid, d.nthr);
  }
  __syncthreads();
  d.cluster_sync();  // every rank loaded (and running) before any reads it

  int count = a.in_count[doc];
  int min_seq = a.in_min_seq[doc];
  int seq = a.in_seq[doc];
  bool overflow = a.in_overflow[doc] != 0;
  // Is every plane's padding one value (that of slot count)?
  const bool in_range = count >= 0 && count <= d.C;
  unsigned bad = 0;
  if (in_range && count < d.C) {  // uniform
    const int q = count / d.Cs;
    for (int p = 0; p < d.P; ++p) {
      const int u = d.remote(d.plane(p), q)[count - q * d.Cs];
      const int* row = d.plane(p);
      for (int l = max(count, d.lo) + d.tid; l < d.hi; l += d.nthr)
        bad |= row[l - d.lo] != u;
    }
  }
  int mn = 0;
  unsigned s2 = 0;
  combine(d, mn, bad, s2);
  d.exact_pad = in_range && bad == 0;

  const long long orow = doc * a.steps;
  for (int t = 0; t < a.steps; ++t) {
    d.view_ok = false;
    apply_one<kRuns>(d, a, (orow + t) * kRunK, load_op(a, orow + t), count,
                     min_seq, seq, overflow);
  }
  __syncthreads();

  if constexpr (kMode == SCAN_GLOBAL)
    store_table(d.S, d.C, a, doc, d.tid, d.nthr);
  else
    copy_rows<false>(d.S, d.Cs, a, doc, d.lo, d.hi, d.tid, d.nthr);
  if (d.rank == 0 && d.tid == 0) {
    a.out_count[doc] = count;
    a.out_min_seq[doc] = min_seq;
    a.out_seq[doc] = seq;
    a.out_overflow[doc] = overflow ? 1 : 0;
  }
  d.cluster_sync();  // no block leaves while another may read its memory
}

template <bool kRuns>
__global__ void __launch_bounds__(kScanThreads) scan_apply_kernel_global(
    ScanArgs s) {
  live_body<kRuns, SCAN_GLOBAL>(s);
}

template <bool kRuns>
__global__ void __launch_bounds__(kScanThreads) scan_apply_kernel_smem(
    ScanArgs s) {
  live_body<kRuns, SCAN_SMEM>(s);
}

template <bool kRuns>
__global__ void __launch_bounds__(kScanThreads) scan_apply_kernel_cluster(
    ScanArgs s) {
  live_body<kRuns, SCAN_CLUSTER>(s);
}

// One launch of B documents x `blocks` blocks, a cluster of `blocks` per
// document when blocks > 1; every CUDA call's error is returned.
template <class Kernel>
cudaError_t launch_scan(Kernel kern, const ScanArgs& s, int blocks,
                        int threads, size_t smem, bool shared_table,
                        cudaStream_t stream) {
  cudaError_t err;
  if (shared_table) {  // the table lives there: all of L1 as shared memory
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (blocks > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (s.a.batch == 0) return cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(s.a.batch) * blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (blocks > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kern, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// The geometry formulas; the Python wrapper (mergetree/kernel.py
// scan_geometry, _forced_geometry) uses the same.
static int chunked_threads(int capacity) {
  return std::min(((capacity + 31) / 32) * 32, kScanThreads);
}

// global_chunked: the reduction scratch, plus the view planes when they
// fit.
static long long chunked_smem_bytes(int capacity) {
  const long long planes = capacity <= kMaxSharedSlots ? 2 : 0;
  return (kScratchInts + planes * capacity) * 4;
}

// global: the live scratch, plus the view planes when they fit.
static long long global_smem_bytes(int capacity) {
  const long long planes = capacity <= kMaxSharedSlots ? 2 : 0;
  return (kLiveScratch + planes * capacity) * 4;
}

// smem (blocks = 1) and cluster: this rank's P planes and two view planes
// of Cs slots, the shift's staging (kRunK slots of each), the scratch.
static long long shared_table_bytes(int capacity, int planes, int blocks) {
  const long long cs = (capacity + blocks - 1) / blocks;
  return ((planes + 2LL) * (cs + kRunK) + kLiveScratch) * 4;
}

// ptrs: as fused_apply.cu's args_from_ptrs takes them without the narrow
// outputs (14 input and 14 output DocState pointers, 10 PackedOps columns,
// with with_runs 3 RunCols columns), then the [B, P, C] work buffer and
// the [B, 2, C] view buffer. path (ScanPath), blocks (per document),
// threads and smem_bytes are the host's launch geometry:
// - global_chunked: blocks 1, threads = C rounded up to 32, at most 512;
// - global: blocks 1, threads a multiple of 32 in 32..512;
// - smem: blocks 1, threads as global, the table in shared memory;
// - cluster: 2 <= blocks <= 16, threads as global;
// smem_bytes as the formulas above (at most 227 KB); the work buffer given
// exactly on the global paths, the view buffer exactly there when C >
// kMaxSharedSlots. K outside 1..8, A < 1, C < 1 or (8 + K + A) x C >= 2^31,
// or any other geometry, is refused with cudaErrorInvalidValue. Returns
// the launch's error.
extern "C" int fluid_scan_apply(void** ptrs, int batch, int capacity,
                                int k_slots, int a_slots, int steps,
                                int with_runs, int path, int blocks,
                                int threads, long long smem_bytes,
                                void* stream) {
  const long long planes = SEG_PLANES + static_cast<long long>(k_slots) +
                           a_slots;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (k_slots < 1 || k_slots > kMaxK || a_slots < 1 || capacity < 1 ||
      batch < 0 || steps < 0 || planes * capacity >= (1LL << 31) ||
      smem_bytes > kSmemLimit)
    return bad;
  const bool global = path == SCAN_GLOBAL_CHUNKED || path == SCAN_GLOBAL;
  const bool threads_ok = threads >= 32 && threads <= kScanThreads &&
                          threads % 32 == 0;
  switch (path) {
    case SCAN_GLOBAL_CHUNKED:
      if (blocks != 1 || threads != chunked_threads(capacity) ||
          smem_bytes != chunked_smem_bytes(capacity))
        return bad;
      break;
    case SCAN_GLOBAL:
      if (blocks != 1 || !threads_ok ||
          smem_bytes != global_smem_bytes(capacity))
        return bad;
      break;
    case SCAN_SMEM:
      if (blocks != 1 || !threads_ok ||
          smem_bytes != shared_table_bytes(capacity, planes, 1))
        return bad;
      break;
    case SCAN_CLUSTER:
      if (blocks < 2 || blocks > kMaxCluster || !threads_ok ||
          static_cast<long long>(batch) * blocks >= (1LL << 31) ||
          smem_bytes != shared_table_bytes(capacity, planes, blocks))
        return bad;
      break;
    default:
      return bad;
  }
  int used = 0;
  ScanArgs s;
  s.a = args_from_ptrs(ptrs, batch, capacity, k_slots, a_slots, steps,
                       with_runs, 0, used);
  s.work = static_cast<int*>(ptrs[used]);
  s.scratch = static_cast<int*>(ptrs[used + 1]);
  if ((s.work != nullptr) != global ||
      (s.scratch != nullptr) != (global && capacity > kMaxSharedSlots))
    return bad;
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool r = with_runs != 0;
  cudaError_t err;
  switch (path) {
    case SCAN_GLOBAL_CHUNKED:
      err = r ? launch_scan(scan_apply_kernel_chunked<true>, s, 1, threads,
                            smem, false, st)
              : launch_scan(scan_apply_kernel_chunked<false>, s, 1, threads,
                            smem, false, st);
      break;
    case SCAN_GLOBAL:
      err = r ? launch_scan(scan_apply_kernel_global<true>, s, 1, threads,
                            smem, false, st)
              : launch_scan(scan_apply_kernel_global<false>, s, 1, threads,
                            smem, false, st);
      break;
    case SCAN_SMEM:
      err = r ? launch_scan(scan_apply_kernel_smem<true>, s, 1, threads,
                            smem, true, st)
              : launch_scan(scan_apply_kernel_smem<false>, s, 1, threads,
                            smem, true, st);
      break;
    default:
      err = r ? launch_scan(scan_apply_kernel_cluster<true>, s, blocks,
                            threads, smem, true, st)
              : launch_scan(scan_apply_kernel_cluster<false>, s, blocks,
                            threads, smem, true, st);
      break;
  }
  return static_cast<int>(err);
}
