// The fused merge-tree apply: the whole op stream of each document applied
// to its segment table held in shared memory.
//
// Replaces: fluidframework_tpu/mergetree/pallas_apply.py,
//   apply_ops_fused_pallas -> _kernel, all three of its variants: plain
//   (runs=None, extract=False), INSERT_RUN (runs=, pallas_apply.py:198-247)
//   and in-kernel extract (extract=True, :514-522), alone or together.
//   What it computes is _apply_one_batched for op t = 0..T-1 of every
//   document: boundary splits at pos1 (and pos2 for ranges), then insert /
//   insert run / remove with overlap clients / annotate ring, then acks,
//   then seq/min_seq. The capacity gate (count + 2 <= C; count + RUN_K + 1
//   for a run) and every overflow rule are the same, and every lane of the
//   table (the padding past `count` too) ends bit-identical to the JAX
//   result. The variants are template parameters (kRuns, kExtract).
//
// Bound on the H100. Bytes: the state is read once and written once,
// (8 + K + A) int32 planes plus four scalars per document, and the ten op
// columns are read once: 0.29 GB at B=10,000, C=256, K=3, A=1, T=100, or
// 87 us at 3.35 TB/s. Operations: every op costs every slot a few dozen
// integer operations (visibility predicate, prefix sum, masks, shifts of
// all planes), about 2.5e10 at that shape (chip_smoke.py counts them from
// the run's op kinds), or 1.5 ms at the SM's integer rate (64 INT32 lanes
// per SM per clock, 132 SMs, 1.98 GHz: 16.7e12/s). So operations bound it.
// The op loop of one document is a chain of dependent steps (each op needs
// the table the previous op left), so the parallelism is across documents
// and across the slots of one table, and what a design can cut is the cost
// of each step: instructions that every thread repeats, and the barriers
// that join the slots of one table.
//
// Two paths, chosen per launch by the host (pallas_apply.launch_geometry:
// the warp path for C <= 512 when the launch has at least 512 documents,
// about four per SM; else the block path; a fixed rule of B and C measured
// on the H100, calibrate_fused_apply.py). This file checks the threads and
// shared memory it is given against its own formulas and refuses a
// mismatch with cudaErrorInvalidValue.
//
// WARP path (C <= 512): one warp per document, W documents per block (W
// warps, W <= 8; the host launches W = 1), and no block barrier anywhere
// in the kernel: a warp whose document is past the batch leaves at once. Slot l of a plane lives
// in row l / 32 at lane l % 32, so a document's (8 + K + A) planes are
// ceil(C/32) rows of 32 words each, and a sweep in which every lane touches
// its slot of one row reads 32 consecutive words, one per bank. That is the
// bank pattern a swizzled layout of per-lane strips (lane i owning slots
// [i S, i S + S), slot i S + j stored at j 32 + i) would give too; rows are
// taken over strips because the live slots [0, count) fill whole rows from
// the bottom, so every sweep below stops at the last live row, while a
// strip of every lane holds live slots until count reaches the last strip
// and each sweep would cost all S steps whatever count is. The visibility
// bits and the exclusive prefix sum live in one register per row (the
// kernel is built for kR rows, a power of two >= ceil(C/32), so the row
// loops unroll). The primitives are warp primitives:
// - visibility + prefix sum: per row, a 5-step __shfl_up_sync scan plus
//   the carry of the rows before it, four rows at a time;
// - first_true, masked sums and the boundary's (min, sum, sum):
//   __reduce_min_sync / __reduce_add_sync; any_lane: __any_sync;
// - shift_right<kBy>: a row at a time from the top down, each lane reads
//   the sources l - kBy of its slot from shared memory (kBy = 1 or RUN_K =
//   8 lanes down, in this row or the one below, so a run's shift crosses
//   rows whatever C is), __syncwarp(), and writes its own slot; the fills
//   of an insert or a run sit between two __syncwarp()s;
// - the op columns are loaded 32 ops at a time, lane j holding op t0 + j,
//   one coalesced load per field, and each op takes its fields by
//   __shfl_sync; on an INSERT_RUN lanes 0-7 load the run's 8 members; the
//   per-op scalars (count, seq, min_seq, overflow) are warp-uniform
//   registers.
// The live extent bounds every sweep. JAX moves and tests every lane of
// the table, padding past `count` included, and the result must match on
// every lane. But no op writes a slot at or past count except an ack,
// which treats identical slots identically, and a shift, which moves
// padding onto padding; so when every plane's padding holds one value on
// entry (checked once per document, with 0 <= count <= C), it holds one
// value after every op, a shift need only move [lo, count + kBy), a
// visibility pass or a stop test need only rows below count (count + 1),
// and an ack reaches the padding exactly when it reaches the first padding
// slot. A document whose padding differs (a reused page's stale rows)
// sweeps the whole table, as JAX does. The cost of an op then follows the
// document's rows, not its capacity (chip_smoke.py's bound counts this
// work, the rows in use, beside the work of every slot).
// The shared memory of a document is (8 + K + A) x ceil(C/32) x 32 x 4
// bytes (12 KB at C = 256, K = 3, A = 1); the 71-127 registers a thread
// takes (ptxas) let 16-28 warps, so 16-28 documents, share an SM, and one
// warp's op loop hides behind the others'.
//
// BLOCK path (any C up to max_fused_capacity): one block per document, one
// thread per slot (blockDim = C rounded up to 32, at most 1024; chunk loops
// cover C > 1024). The planes plus the per-op prefix-sum and visibility
// planes stay in shared memory ((10 + K + A) x C x 4 bytes). Block
// primitives: the prefix sum is a warp-shuffle scan plus per-warp totals;
// first_true / masked sums are __reduce_*_sync plus per-warp partials;
// any_lane is __syncthreads_or; the shift reads lane - kBy into registers,
// barriers, and writes back, chunks high to low. Every op sweeps all C
// slots and joins them with about fifteen __syncthreads(). It stays for
// C > 512, and for launches of fewer than 512 documents: one warp each
// leaves the SMs short of warps to hide an op's latency, and C threads per
// document finish each op sooner than one warp does.
//
// Both paths:
// - The table is loaded with cp.async (load_table): each thread starts all
//   of its 4-byte copies before the first completes, so a launch of few
//   ops, whose time is the load and store of the state, keeps enough
//   requests in flight for the memory system without staging them in
//   registers. rem_clients / anno are read in their [B, C, K] / [B, C, A]
//   layout and written back the same way: no plane copies outside the
//   kernel.
// - The run shift moves lanes >= slot + 8 from lane - 8. JAX rolls
//   cyclically over lanes >= slot, but lanes [slot, slot + 8) are then
//   overwritten on every plane by the fills, so no wrapped value survives
//   and the kernel never reads across the end of the table. A fill indexes
//   its member directly by rel = lane - slot (JAX's 8-term select). Run
//   member lengths are >= 0 (RunCols: 0 marks padding); a fill treats
//   length 0 as a dead row and > 0 as a live one, as JAX does.
// - Integer adds wrap in unsigned arithmetic as int32 does in JAX, and no
//   comparison widens the INT32_MAX-1 / INT32_MAX sentinels.
// - The per-slot rules (visibility, insert stop, fills, remove with overlap
//   clients, annotate ring, acks) are one set of functions on a Slot, an
//   address plus a plane stride, so both paths run the same rule code.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnassigned = 0x7fffffff;  // DEV_UNASSIGNED
constexpr int kNoRemove = 0x7ffffffe;    // DEV_NO_REMOVE
constexpr int kMaxK = 8;
constexpr int kMaxPlanes = 32;
constexpr int kShiftGroup = 16;
constexpr int kMaxThreads = 1024;
constexpr int kScratchInts = 128;        // 3 x 32 reduction + 32 scan slots
constexpr int kRunK = 8;                 // oppack.RUN_K
constexpr int kMaxDocsPerBlock = 8;      // warp path: W
constexpr int kMaxRows = 16;             // warp path: C <= 16 x 32

enum OpKindCode { NOOP = 0, INSERT = 1, REMOVE = 2, ANNOTATE = 3,
                  ACK_INSERT = 4, ACK_REMOVE = 5, INSERT_RUN = 6 };
enum Plane { LEN = 0, INS_SEQ, INS_CLIENT, LOCAL_SEQ, REM_SEQ,
             REM_LOCAL_SEQ, ORIGIN_OP, ORIGIN_OFF, SEG_PLANES };
enum OpField { F_KIND = 0, F_SEQ, F_REF_SEQ, F_CLIENT, F_POS1, F_POS2,
               F_OP_ID, F_NEW_LEN, F_LOCAL_SEQ, F_MSN, N_OP_FIELDS };
enum Path { PATH_BLOCK = 0, PATH_WARP = 1 };  // pallas_apply._PATHS

// Pointers in DocState field order: 8 segment planes, rem_clients, anno,
// count, min_seq, seq, overflow; then the PackedOps columns.
struct Args {
  const int* in_seg[SEG_PLANES];
  const int* in_rc;
  const int* in_anno;
  const int* in_count;
  const int* in_min_seq;
  const int* in_seq;
  const uint8_t* in_overflow;
  int* out_seg[SEG_PLANES];
  int* out_rc;
  int* out_anno;
  int* out_count;
  int* out_min_seq;
  int* out_seq;
  uint8_t* out_overflow;
  const int* op[N_OP_FIELDS];
  const int* run_len;   // [B, T, kRunK] RunCols, kRuns only
  const int* run_seq;
  const int* run_id;
  int16_t* ex_overflow;  // [B] narrow outputs, kExtract only
  int* ex_count;
  int* ex_min_seq;
  int* ex_seq;
  int batch, capacity, k_slots, a_slots, steps;
};

struct Op {
  int kind, seq, ref_seq, client, pos1, pos2, op_id, new_len, local_seq, msn;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// ---------------------------------------------------------------------------
// the table's load and store, shared by both paths
// ---------------------------------------------------------------------------

// Thread tid of nthr copies its share of one document's table between
// device memory and shared memory (slot l of plane p at S[p * stride + l]).
// The interleaved [C, n] planes (rem_clients, anno) go element by element:
// element e is plane e % n, slot e / n, tracked without a division per
// element.
template <bool kLoad, class G>
__device__ __forceinline__ void copy_interleaved(int* S, int stride, G* g,
                                                 int C, int n, int tid,
                                                 int nthr) {
  int l = tid / n, p = tid % n;
  const int dl = nthr / n, dp = nthr % n;
  for (int e = tid; e < C * n; e += nthr) {
    int* s = S + p * stride + l;
    if constexpr (kLoad)
      __pipeline_memcpy_async(s, g + e, sizeof(int));
    else
      g[e] = *s;
    l += dl;
    p += dp;
    if (p >= n) {
      p -= n;
      ++l;
    }
  }
}

// cp.async copies, complete for this thread on return; the caller joins
// its threads (__syncwarp / __syncthreads) before any of them reads
// another's slots.
__device__ __forceinline__ void load_table(int* S, int stride, const Args& a,
                                           long long doc, int tid,
                                           int nthr) {
  const int C = a.capacity, K = a.k_slots;
  const long long row = doc * C;
  for (int p = 0; p < SEG_PLANES; ++p)
    for (int l = tid; l < C; l += nthr)
      __pipeline_memcpy_async(S + p * stride + l, a.in_seg[p] + row + l,
                              sizeof(int));
  copy_interleaved<true>(S + SEG_PLANES * stride, stride,
                         a.in_rc + row * K, C, K, tid,
                         nthr);
  copy_interleaved<true>(S + (SEG_PLANES + K) * stride, stride,
                         a.in_anno + row * a.a_slots, C,
                         a.a_slots, tid, nthr);
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The caller has joined its threads after their last write of the table.
__device__ __forceinline__ void store_table(int* S, int stride, const Args& a,
                                            long long doc, int tid,
                                            int nthr) {
  const int C = a.capacity, K = a.k_slots;
  const long long row = doc * C;
  for (int p = 0; p < SEG_PLANES; ++p)
    for (int l = tid; l < C; l += nthr)
      a.out_seg[p][row + l] = S[p * stride + l];
  copy_interleaved<false>(S + SEG_PLANES * stride, stride,
                          a.out_rc + row * K, C, K, tid, nthr);
  copy_interleaved<false>(S + (SEG_PLANES + K) * stride, stride,
                          a.out_anno + row * a.a_slots, C, a.a_slots, tid,
                          nthr);
}

// ---------------------------------------------------------------------------
// per-slot rules, shared by both paths
// ---------------------------------------------------------------------------

// One slot of a table: plane p at base[p * pstride].
struct Slot {
  int* base;
  int pstride;
  __device__ __forceinline__ int& operator[](int p) const {
    return base[p * pstride];
  }
};

// pallas_apply._visibility for a slot below count.
__device__ __forceinline__ bool slot_visible(Slot s, int k, int ref,
                                             int client) {
  const bool inserted = s[INS_SEQ] <= ref || s[INS_CLIENT] == client;
  bool removed = s[REM_SEQ] <= ref;
#pragma unroll 1
  for (int i = 0; i < k; ++i) removed |= s[SEG_PLANES + i] == client;
  return inserted && !removed;
}

// The tie-break stop test of _insert_phase (local_ok = is_local) and of
// _insert_run_phase (local_ok = false).
__device__ __forceinline__ bool insert_stop(Slot s, bool vis, int cum,
                                            bool past_count, const Op& op,
                                            bool local_ok) {
  if (cum != op.pos1) return false;
  const bool tomb = s[REM_SEQ] <= op.ref_seq;
  const bool acked_ins = s[INS_SEQ] != kUnassigned;
  return vis || (!tomb && (local_ok || acked_ins)) || past_count;
}

// Plane p of the row an INSERT lands.
__device__ __forceinline__ int insert_value(int p, const Op& op) {
  switch (p) {
    case LEN: return op.new_len;
    case INS_SEQ: return op.seq;
    case INS_CLIENT: return op.client;
    case LOCAL_SEQ: return op.seq == kUnassigned ? op.local_seq : 0;
    case REM_SEQ: return kNoRemove;
    case REM_LOCAL_SEQ: return 0;
    case ORIGIN_OP: return op.op_id;
    case ORIGIN_OFF: return 0;
    default: return -1;  // rem_clients and anno slots
  }
}

// Plane p of an INSERT_RUN member row (length 0 is a dead padding row).
__device__ __forceinline__ int run_value(int p, int len, int seq, int id,
                                         int client) {
  const bool live = len > 0;
  switch (p) {
    case LEN: return len;
    case INS_SEQ: return live ? seq : 0;
    case INS_CLIENT: return live ? client : -1;
    case LOCAL_SEQ: return 0;
    case REM_SEQ: return live ? kNoRemove : 0;
    case REM_LOCAL_SEQ: return 0;
    case ORIGIN_OP: return id;
    case ORIGIN_OFF: return 0;
    default: return -1;  // rem_clients and anno slots
  }
}

__device__ __forceinline__ bool range_target(Slot s, bool vis, int c,
                                             const Op& op) {
  if (!vis) return false;
  const int len = s[LEN];
  return len > 0 && c >= op.pos1 && wadd(c, len) <= op.pos2;
}

// pallas_apply._append_overlap on one slot's overlap clients: the client
// goes into the first slot >= 1 that was free.
__device__ __forceinline__ void append_overlap(int (&rc)[kMaxK], int k,
                                               bool need, int client) {
  bool taken = false;
#pragma unroll
  for (int i = 1; i < kMaxK; ++i) {
    if (i < k) {
      const bool free_i = rc[i] == -1;
      if (need && free_i && !taken) rc[i] = client;
      taken |= free_i;
    }
  }
}

// pallas_apply._remove_phase on one target slot; returns its overflow.
__device__ __forceinline__ bool remove_slot(Slot s, int k, const Op& op) {
  const bool is_local = op.seq == kUnassigned;
  const int rs = s[REM_SEQ];
  const bool fresh = rs == kNoRemove;
  const bool pend = rs == kUnassigned && !is_local;
  const bool already = rs != kNoRemove && !pend;
  if (fresh) {
    s[REM_SEQ] = is_local ? kUnassigned : op.seq;
    if (is_local) s[REM_LOCAL_SEQ] = op.local_seq;
  } else if (pend) {
    s[REM_SEQ] = op.seq;
    s[REM_LOCAL_SEQ] = 0;
  }
  int rc[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < k) rc[i] = s[SEG_PLANES + i];
  const int prior = rc[0];
  if (fresh || pend) rc[0] = op.client;
  const bool displaced = pend && prior != op.client;
  append_overlap(rc, k, displaced, prior);
  bool has_client = false;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < k) has_client |= rc[i] == op.client;
  const bool need = already && !has_client;
  append_overlap(rc, k, need, op.client);
  const int want = displaced ? prior : op.client;
  bool landed = false;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < k) landed |= rc[i] == want;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < k) s[SEG_PLANES + i] = rc[i];
  return (displaced || need) && !landed;
}

// pallas_apply._annotate_phase on one target slot: push op_id onto its
// ring; returns its overflow.
__device__ __forceinline__ bool annotate_slot(Slot s, int k, int a,
                                              const Op& op) {
  const int an = SEG_PLANES + k;
  const bool over = s[an + a - 1] != -1;
  for (int i = a - 1; i > 0; --i) s[an + i] = s[an + i - 1];
  s[an] = op.op_id;
  return over;
}

// pallas_apply._ack_phase on one slot (every slot, padding included).
__device__ __forceinline__ void ack_slot(Slot s, const Op& op) {
  if (op.kind == ACK_INSERT && s[INS_SEQ] == kUnassigned &&
      s[LOCAL_SEQ] == op.local_seq) {
    s[INS_SEQ] = op.seq;
    s[LOCAL_SEQ] = 0;
  }
  if (op.kind == ACK_REMOVE && s[REM_SEQ] == kUnassigned &&
      s[REM_LOCAL_SEQ] == op.local_seq) {
    s[REM_SEQ] = op.seq;
    s[REM_LOCAL_SEQ] = 0;
  }
}

// pallas_apply._apply_one_batched for one document on either path (D is
// Blk or Warp<kR>). Only the phase of the op's kind runs: the others are
// identities on their disabled masks. `run` is the op's row offset into
// the RunCols columns (kRuns only).
template <bool kRuns, class D>
__device__ __forceinline__ void apply_one(D& d, const Args& a, long long run,
                                          const Op& op, int& count,
                                          int& min_seq, int& seq,
                                          bool& overflow) {
  const int kind = op.kind;
  const bool is_run = kRuns && kind == INSERT_RUN;
  bool is_edit = kind == INSERT || kind == REMOVE || kind == ANNOTATE ||
                 is_run;
  bool is_range = kind == REMOVE || kind == ANNOTATE;
  const bool fits = count + (is_run ? kRunK + 1 : 2) <= d.C;
  if (is_edit && !fits) overflow = true;
  is_edit = is_edit && fits;
  is_range = is_range && fits;
  if (is_edit) ensure_boundary(d, op.pos1, op.ref_seq, op.client, count);
  if (is_range) ensure_boundary(d, op.pos2, op.ref_seq, op.client, count);
  if (is_edit) {
    visibility(d, op.ref_seq, op.client, count);
    if (kind == INSERT) insert_phase(d, op, count, overflow);
    else if (is_run) insert_run_phase(d, a, run, op, count, overflow);
    else if (kind == REMOVE) remove_phase(d, op, overflow);
    else annotate_phase(d, op, overflow);
  }
  if (kind == ACK_INSERT || kind == ACK_REMOVE) ack_phase(d, op, count);
  if (kind != NOOP && op.seq != kUnassigned) {
    seq = max(seq, op.seq);
    min_seq = max(min_seq, op.msn);
  }
}

// ---------------------------------------------------------------------------
// BLOCK path: one block per document, one thread per slot
// ---------------------------------------------------------------------------

struct Blk {
  int* S;      // [P][C] segment planes
  int* cum;    // [C] exclusive prefix sum of visible lengths
  int* vis;    // [C] visibility
  int* red;    // [96] per-warp reduction partials
  int* scan;   // [32] per-warp scan totals
  int C, K, A, P, nthr, tid, warp, lane, nwarps;

  __device__ int& at(int p, int l) { return S[p * C + l]; }
  __device__ Slot slot(int l) const { return Slot{S + l, C}; }
};

// Block-wide (min, sum, sum); every thread gets the result.
__device__ void reduce_min_sum2(Blk& b, int& mn, unsigned& s1, unsigned& s2) {
  mn = __reduce_min_sync(kFull, mn);
  s1 = __reduce_add_sync(kFull, s1);
  s2 = __reduce_add_sync(kFull, s2);
  if (b.lane == 0) {
    b.red[b.warp] = mn;
    b.red[32 + b.warp] = static_cast<int>(s1);
    b.red[64 + b.warp] = static_cast<int>(s2);
  }
  __syncthreads();
  mn = b.red[0];
  s1 = static_cast<unsigned>(b.red[32]);
  s2 = static_cast<unsigned>(b.red[64]);
  for (int w = 1; w < b.nwarps; ++w) {
    mn = min(mn, b.red[w]);
    s1 += static_cast<unsigned>(b.red[32 + w]);
    s2 += static_cast<unsigned>(b.red[64 + w]);
  }
  __syncthreads();
}

__device__ int reduce_min(Blk& b, int mn) {
  mn = __reduce_min_sync(kFull, mn);
  if (b.lane == 0) b.red[b.warp] = mn;
  __syncthreads();
  mn = b.red[0];
  for (int w = 1; w < b.nwarps; ++w) mn = min(mn, b.red[w]);
  __syncthreads();
  return mn;
}

// Exclusive prefix sum of one value per thread (in thread order); total is
// the block's sum.
__device__ unsigned block_excl_scan(Blk& b, unsigned v, unsigned& total) {
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (b.lane >= o) x += y;
  }
  if (b.lane == 31) b.scan[b.warp] = static_cast<int>(x);
  __syncthreads();
  unsigned before = 0, tot = 0;
  for (int w = 0; w < b.nwarps; ++w) {
    const unsigned t = static_cast<unsigned>(b.scan[w]);
    if (w < b.warp) before += t;
    tot += t;
  }
  __syncthreads();
  total = tot;
  return before + x - v;
}

// vis / cum planes at perspective (ref, client) (pallas_apply._visibility).
__device__ void visibility(Blk& b, int ref, int client, int count) {
  unsigned carry = 0;
  for (int base = 0; base < b.C; base += b.nthr) {
    const int l = base + b.tid;
    unsigned vlen = 0;
    int vis = 0;
    if (l < b.C) {
      vis = l < count && slot_visible(b.slot(l), b.K, ref, client);
      vlen = vis ? static_cast<unsigned>(b.at(LEN, l)) : 0u;
    }
    unsigned total;
    const unsigned ex = block_excl_scan(b, vlen, total);
    if (l < b.C) {
      b.cum[l] = static_cast<int>(carry + ex);
      b.vis[l] = vis;
    }
    carry += total;
  }
}

// Lanes l >= lo take lane l - kBy on every plane; callers keep lo >= kBy
// (lanes below lo that JAX's cyclic roll would fill are overwritten on
// every plane by the caller). Chunks go high to low so a chunk reads its
// lower neighbour unmodified (kBy < blockDim); planes move kShiftGroup at a
// time so the staging stays in registers under the 64-register cap of a
// 1024-thread block.
template <int kBy>
__device__ void shift_right(Blk& b, int lo) {
  const int nchunks = (b.C + b.nthr - 1) / b.nthr;
  for (int j = nchunks - 1; j >= 0; --j) {
    if ((j + 1) * b.nthr <= lo) break;  // uniform
    const int l = j * b.nthr + b.tid;
    const bool act = l < b.C && l >= lo;
    for (int g = 0; g < b.P; g += kShiftGroup) {
      int tmp[kShiftGroup];
#pragma unroll
      for (int q = 0; q < kShiftGroup; ++q)
        if (g + q < b.P && act) tmp[q] = b.S[(g + q) * b.C + l - kBy];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kShiftGroup; ++q)
        if (g + q < b.P && act) b.S[(g + q) * b.C + l] = tmp[q];
      __syncthreads();
    }
  }
}

// pallas_apply._ensure_boundary: split the visible segment strictly
// containing pos into [.., pos) and [pos, ..).
__device__ void ensure_boundary(Blk& b, int pos, int ref, int client,
                                int& count) {
  visibility(b, ref, client, count);
  int mn = b.C;
  unsigned scum = 0, slen = 0;
  for (int l = b.tid; l < b.C; l += b.nthr) {
    if (!b.vis[l]) continue;
    const int c = b.cum[l];
    const int len = b.at(LEN, l);
    if (c < pos && pos < wadd(c, len)) {
      mn = min(mn, l);
      scum += static_cast<unsigned>(c);
      slen += static_cast<unsigned>(len);
    }
  }
  reduce_min_sum2(b, mn, scum, slen);
  if (mn >= b.C) return;  // no lane inside: nothing to split
  const int slot = mn;
  const int off = wsub(pos, static_cast<int>(scum));
  shift_right<1>(b, slot + 1);
  count += 1;
  if (b.tid == 0) {
    b.at(LEN, slot) = off;
    if (slot + 1 < b.C) {
      b.at(LEN, slot + 1) = wsub(static_cast<int>(slen), off);
      b.at(ORIGIN_OFF, slot + 1) = wadd(b.at(ORIGIN_OFF, slot + 1), off);
    }
  }
  __syncthreads();
}

// pallas_apply._insert_phase (vis/cum hold the post-boundary view).
__device__ void insert_phase(Blk& b, const Op& op, int& count,
                             bool& overflow) {
  const bool is_local = op.seq == kUnassigned;
  int mn = b.C;
  for (int l = b.tid; l < b.C; l += b.nthr)
    if (insert_stop(b.slot(l), b.vis[l], b.cum[l], l >= count, op,
                    is_local))
      mn = min(mn, l);
  mn = reduce_min(b, mn);
  if (mn >= b.C) {  // no tie-break slot: flagged, state unchanged
    overflow = true;
    return;
  }
  const int slot = mn;
  shift_right<1>(b, max(slot, 1));  // lane 0 is overwritten below
  count += 1;
  for (int p = b.tid; p < b.P; p += b.nthr)
    b.S[p * b.C + slot] = insert_value(p, op);
  __syncthreads();
}

// pallas_apply._insert_run_phase (vis/cum hold the post-boundary view): the
// members of run row `run` ([kRunK] in each RunCols column) land as
// contiguous rows at the first member's tie-break slot.
__device__ void insert_run_phase(Blk& b, const Args& a, long long run,
                                 const Op& op, int& count, bool& overflow) {
  int mn = b.C;
  for (int l = b.tid; l < b.C; l += b.nthr)
    if (insert_stop(b.slot(l), b.vis[l], b.cum[l], l >= count, op, false))
      mn = min(mn, l);
  mn = reduce_min(b, mn);
  if (mn >= b.C) {  // no tie-break slot: flagged, state unchanged
    overflow = true;
    return;
  }
  const int slot = mn;
  shift_right<kRunK>(b, slot + kRunK);
  count += kRunK;
  for (int e = b.tid; e < kRunK * b.P; e += b.nthr) {
    const int rel = e % kRunK;
    const int p = e / kRunK;
    const int l = slot + rel;
    if (l >= b.C) continue;
    b.S[p * b.C + l] = run_value(p, __ldg(a.run_len + run + rel),
                                 __ldg(a.run_seq + run + rel),
                                 __ldg(a.run_id + run + rel), op.client);
  }
  __syncthreads();
}

// pallas_apply._remove_phase: per lane, then one any-lane overflow vote.
__device__ void remove_phase(Blk& b, const Op& op, bool& overflow) {
  int over = 0;
  for (int l = b.tid; l < b.C; l += b.nthr)
    if (range_target(b.slot(l), b.vis[l], b.cum[l], op))
      over |= remove_slot(b.slot(l), b.K, op);
  if (__syncthreads_or(over)) overflow = true;
}

// pallas_apply._annotate_phase: push op_id onto each target's ring.
__device__ void annotate_phase(Blk& b, const Op& op, bool& overflow) {
  int over = 0;
  for (int l = b.tid; l < b.C; l += b.nthr)
    if (range_target(b.slot(l), b.vis[l], b.cum[l], op))
      over |= annotate_slot(b.slot(l), b.K, b.A, op);
  if (__syncthreads_or(over)) overflow = true;
}

// pallas_apply._ack_phase: every lane, padding included.
__device__ void ack_phase(Blk& b, const Op& op, int /*count*/) {
  for (int l = b.tid; l < b.C; l += b.nthr) ack_slot(b.slot(l), op);
}

template <bool kRuns, bool kExtract>
__global__ void __launch_bounds__(kMaxThreads) fused_apply_kernel_block(
    Args a) {
  extern __shared__ int smem[];
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
  b.S = smem;
  b.cum = smem + b.P * b.C;
  b.vis = b.cum + b.C;
  b.red = b.vis + b.C;
  b.scan = b.red + 96;

  const long long doc = blockIdx.x;
  int count = a.in_count[doc];
  int min_seq = a.in_min_seq[doc];
  int seq = a.in_seq[doc];
  bool overflow = a.in_overflow[doc] != 0;
  load_table(b.S, b.C, a, doc, b.tid, b.nthr);
  __syncthreads();

  const long long orow = doc * a.steps;
  for (int t = 0; t < a.steps; ++t) {
    Op op;
    op.kind = __ldg(a.op[F_KIND] + orow + t);
    op.seq = __ldg(a.op[F_SEQ] + orow + t);
    op.ref_seq = __ldg(a.op[F_REF_SEQ] + orow + t);
    op.client = __ldg(a.op[F_CLIENT] + orow + t);
    op.pos1 = __ldg(a.op[F_POS1] + orow + t);
    op.pos2 = __ldg(a.op[F_POS2] + orow + t);
    op.op_id = __ldg(a.op[F_OP_ID] + orow + t);
    op.new_len = __ldg(a.op[F_NEW_LEN] + orow + t);
    op.local_seq = __ldg(a.op[F_LOCAL_SEQ] + orow + t);
    op.msn = __ldg(a.op[F_MSN] + orow + t);
    apply_one<kRuns>(b, a, (orow + t) * kRunK, op, count, min_seq, seq,
                     overflow);
  }
  __syncthreads();

  store_table(b.S, b.C, a, doc, b.tid, b.nthr);
  if (b.tid == 0) {
    a.out_count[doc] = count;
    a.out_min_seq[doc] = min_seq;
    a.out_seq[doc] = seq;
    a.out_overflow[doc] = overflow ? 1 : 0;
    if (kExtract) {  // _kernel's last-step narrow outputs
      a.ex_overflow[doc] = static_cast<int16_t>(overflow ? 1 : 0);
      a.ex_count[doc] = count;
      a.ex_min_seq[doc] = min_seq;
      a.ex_seq[doc] = seq;
    }
  }
}

// ---------------------------------------------------------------------------
// WARP path: one warp per document, slot l in row l / 32 at lane l % 32
// ---------------------------------------------------------------------------

// kR: the rows of 32 slots the kernel is built for, a power of two >= the
// table's rows; every loop over rows is unrolled and cut at run time.
template <int kR>
struct Warp {
  int* S;          // this document's planes: slot l of plane p at p*stride + l
  int C, K, A, P, lane, stride;
  bool exact_pad;  // 0 <= count <= C and each plane's slots >= count agree
  int rows;        // rows that hold the last view's visible slots
  unsigned vis;    // bit r: slot r*32 + lane visible at the last view
  int cum[kR];     // exclusive prefix sum of visible lengths at that slot

  __device__ __forceinline__ int slot_of(int r) const { return r * 32 + lane; }
  // Row r of this lane: slot r*32 + lane.
  __device__ __forceinline__ Slot row(int r) const {
    return Slot{S + r * 32 + lane, stride};
  }
  // Any slot of the table.
  __device__ __forceinline__ Slot at(int l) const { return Slot{S + l, stride}; }
  __device__ __forceinline__ bool visible(int r) const {
    return (vis >> r) & 1u;
  }
  // The slots [0, extent(end)) are all an op has to touch when count <= end:
  // with exact padding, the slots at or past count hold the padding values,
  // which no op but an ack changes; else the whole table.
  __device__ __forceinline__ int extent(int end) const {
    return exact_pad ? min(end, C) : C;
  }
  __device__ __forceinline__ int rows_of(int n) const { return (n + 31) >> 5; }
};

// Rows go kG at a time, so that their loads and the steps of their scans
// overlap; the loop stops at the live rows (every loop over rows does: the
// unrolled rows past them would cost their guards on every op), and the
// rows past it only take the carry.
template <int kR>
__device__ __forceinline__ void visibility(Warp<kR>& w, int ref, int client,
                                           int count) {
  constexpr int kG = kR < 4 ? kR : 4;
  const int rows = w.rows_of(w.extent(count));  // no visible slot beyond
  w.rows = rows;
  unsigned carry = 0;
  w.vis = 0;
#pragma unroll
  for (int g = 0; g < kR; g += kG) {
    if (g >= rows) break;  // uniform
    unsigned v[kG], x[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int l = w.slot_of(g + i);
      v[i] = 0;
      if (l < w.C && l < count) {
        const Slot s = w.row(g + i);
        const int len = s[LEN];
        if (slot_visible(s, w.K, ref, client)) {
          w.vis |= 1u << (g + i);
          v[i] = static_cast<unsigned>(len);
        }
      }
      x[i] = v[i];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const unsigned y = __shfl_up_sync(kFull, x[i], o);
        if (w.lane >= o) x[i] += y;
      }
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      w.cum[g + i] = static_cast<int>(carry + x[i] - v[i]);
      carry += __shfl_sync(kFull, x[i], 31);
    }
  }
  const int done = (rows + kG - 1) / kG * kG;
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (r >= done) w.cum[r] = static_cast<int>(carry);
}

// Slots l in [lo, hi) take slot l - kBy on every plane; callers keep
// lo >= kBy and hi <= C. A row at a time from the top down, kPG planes at
// a time, each lane reads the sources of its slot (another lane's slot, in
// this row or the one below), the warp syncs, and each lane writes its own
// slot: a row's sources are read before the row below is written.
template <int kBy, int kR>
__device__ __forceinline__ void shift_right(Warp<kR>& w, int lo, int hi) {
  constexpr int kPG = 8;
  if (lo >= hi) return;
  const int r0 = lo >> 5, r1 = (hi - 1) >> 5;
  __syncwarp();  // earlier writes of the source slots are visible
  for (int r = r1; r >= r0; --r) {
    const int l = w.slot_of(r);
    const bool act = l >= lo && l < hi;
    for (int p0 = 0; p0 < w.P; p0 += kPG) {
      int* base = w.S + p0 * w.stride + l;
      int v[kPG];
#pragma unroll
      for (int q = 0; q < kPG; ++q)
        if (act && p0 + q < w.P) v[q] = base[q * w.stride - kBy];
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kPG; ++q)
        if (act && p0 + q < w.P) base[q * w.stride] = v[q];
    }
  }
}

template <int kR>
__device__ __forceinline__ void ensure_boundary(Warp<kR>& w, int pos,
                                                int ref, int client,
                                                int& count) {
  visibility(w, ref, client, count);
  int mn = w.C;
  unsigned scum = 0, slen = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= w.rows) break;
    if (!w.visible(r)) continue;
    const int c = w.cum[r];
    const int len = w.row(r)[LEN];
    if (c < pos && pos < wadd(c, len)) {
      mn = min(mn, w.slot_of(r));
      scum += static_cast<unsigned>(c);
      slen += static_cast<unsigned>(len);
    }
  }
  mn = __reduce_min_sync(kFull, mn);
  scum = __reduce_add_sync(kFull, scum);
  slen = __reduce_add_sync(kFull, slen);
  if (mn >= w.C) return;  // no slot inside: nothing to split
  const int slot = mn;
  const int off = wsub(pos, static_cast<int>(scum));
  shift_right<1>(w, slot + 1, w.extent(count + 1));
  count += 1;
  // the lanes of slot and slot + 1 write their own slots
  if (w.lane == (slot & 31)) w.at(slot)[LEN] = off;
  if (slot + 1 < w.C && w.lane == ((slot + 1) & 31)) {
    const Slot r = w.at(slot + 1);
    r[LEN] = wsub(static_cast<int>(slen), off);
    r[ORIGIN_OFF] = wadd(r[ORIGIN_OFF], off);
  }
}

// First slot whose insert stop test holds, C if none (the whole warp). With
// exact padding the first padding slot (count) stands for all of them.
template <int kR>
__device__ __forceinline__ int first_stop(const Warp<kR>& w, const Op& op,
                                          int count, bool local_ok) {
  const int n = w.extent(count + 1);
  const int rows = w.rows_of(n);
  int mn = w.C;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= rows) break;
    const int l = w.slot_of(r);
    if (l < n && insert_stop(w.row(r), w.visible(r), w.cum[r], l >= count,
                             op, local_ok))
      mn = min(mn, l);
  }
  return __reduce_min_sync(kFull, mn);
}

template <int kR>
__device__ __forceinline__ void insert_phase(Warp<kR>& w, const Op& op,
                                             int& count, bool& overflow) {
  const int slot = first_stop(w, op, count, op.seq == kUnassigned);
  if (slot >= w.C) {  // no tie-break slot: flagged, state unchanged
    overflow = true;
    return;
  }
  shift_right<1>(w, max(slot, 1), w.extent(count + 1));  // slot 0 refilled
  count += 1;
  __syncwarp();
  if (w.lane < w.P) w.at(slot)[w.lane] = insert_value(w.lane, op);
  __syncwarp();
}

template <int kR>
__device__ __forceinline__ void insert_run_phase(Warp<kR>& w, const Args& a,
                                                 long long run, const Op& op,
                                                 int& count, bool& overflow) {
  const int slot = first_stop(w, op, count, false);
  if (slot >= w.C) {  // no tie-break slot: flagged, state unchanged
    overflow = true;
    return;
  }
  shift_right<kRunK>(w, slot + kRunK, w.extent(count + kRunK));
  count += kRunK;
  // lanes 0..7 load the members; lane i fills member i % 8 on planes
  // i / 8, i / 8 + 4, ...
  const int rel = w.lane % kRunK;
  int len = 0, rseq = 0, id = 0;
  if (w.lane < kRunK) {
    len = __ldg(a.run_len + run + rel);
    rseq = __ldg(a.run_seq + run + rel);
    id = __ldg(a.run_id + run + rel);
  }
  len = __shfl_sync(kFull, len, rel);
  rseq = __shfl_sync(kFull, rseq, rel);
  id = __shfl_sync(kFull, id, rel);
  const int l = slot + rel;
  __syncwarp();
  if (l < w.C) {
    const Slot s = w.at(l);
    for (int p = w.lane / kRunK; p < w.P; p += 32 / kRunK)
      s[p] = run_value(p, len, rseq, id, op.client);
  }
  __syncwarp();
}

template <int kR>
__device__ __forceinline__ void remove_phase(Warp<kR>& w, const Op& op,
                                             bool& overflow) {
  bool over = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= w.rows) break;
    if (range_target(w.row(r), w.visible(r), w.cum[r], op))
      over |= remove_slot(w.row(r), w.K, op);
  }
  if (__any_sync(kFull, over)) overflow = true;
}

template <int kR>
__device__ __forceinline__ void annotate_phase(Warp<kR>& w, const Op& op,
                                               bool& overflow) {
  bool over = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= w.rows) break;
    if (range_target(w.row(r), w.visible(r), w.cum[r], op))
      over |= annotate_slot(w.row(r), w.K, w.A, op);
  }
  if (__any_sync(kFull, over)) overflow = true;
}

// Every slot, padding included: with exact padding, the first padding slot
// decides whether the ack reaches the padding (all of it) or not.
template <int kR>
__device__ __forceinline__ void ack_phase(Warp<kR>& w, const Op& op,
                                          int count) {
  int n = w.extent(count);
  if (n < w.C) {
    __syncwarp();
    const Slot pad = w.at(n);
    const bool hit = op.kind == ACK_INSERT
        ? pad[INS_SEQ] == kUnassigned && pad[LOCAL_SEQ] == op.local_seq
        : pad[REM_SEQ] == kUnassigned && pad[REM_LOCAL_SEQ] == op.local_seq;
    if (hit) n = w.C;
    __syncwarp();  // every lane has read the padding slot before it changes
  }
  const int rows = w.rows_of(n);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= rows) break;
    if (w.slot_of(r) < n) ack_slot(w.row(r), op);
  }
}

template <int kR, bool kRuns, bool kExtract>
__global__ void __launch_bounds__(32 * kMaxDocsPerBlock)
    fused_apply_kernel_warp(Args a) {
  extern __shared__ int smem[];
  const int wid = threadIdx.x >> 5;
  const long long doc =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + wid;
  if (doc >= a.batch) return;  // the whole warp: no block barrier follows
  Warp<kR> w;
  w.C = a.capacity;
  w.K = a.k_slots;
  w.A = a.a_slots;
  w.P = SEG_PLANES + a.k_slots + a.a_slots;
  w.lane = threadIdx.x & 31;
  w.stride = (w.C + 31) / 32 * 32;
  w.S = smem + wid * w.P * w.stride;

  const int C = w.C;
  int count = a.in_count[doc];
  int min_seq = a.in_min_seq[doc];
  int seq = a.in_seq[doc];
  bool overflow = a.in_overflow[doc] != 0;
  load_table(w.S, w.stride, a, doc, w.lane, 32);
  __syncwarp();
  bool exact = count >= 0 && count <= C;
  if (exact && count < C) {  // is every plane's padding one value?
    for (int p = 0; p < w.P; ++p) {
      const int u = w.at(count)[p];
      for (int l = count + w.lane; l < C; l += 32) exact &= w.at(l)[p] == u;
    }
  }
  w.exact_pad = __all_sync(kFull, exact);

  const long long orow = doc * a.steps;
  int col[N_OP_FIELDS];  // op t0 + lane of each column
  for (int t = 0; t < a.steps; ++t) {
    const int src = t & 31;
    if (src == 0) {
      const bool in = t + w.lane < a.steps;
#pragma unroll
      for (int f = 0; f < N_OP_FIELDS; ++f)
        col[f] = in ? __ldg(a.op[f] + orow + t + w.lane) : 0;
    }
    Op op;
    op.kind = __shfl_sync(kFull, col[F_KIND], src);
    op.seq = __shfl_sync(kFull, col[F_SEQ], src);
    op.ref_seq = __shfl_sync(kFull, col[F_REF_SEQ], src);
    op.client = __shfl_sync(kFull, col[F_CLIENT], src);
    op.pos1 = __shfl_sync(kFull, col[F_POS1], src);
    op.pos2 = __shfl_sync(kFull, col[F_POS2], src);
    op.op_id = __shfl_sync(kFull, col[F_OP_ID], src);
    op.new_len = __shfl_sync(kFull, col[F_NEW_LEN], src);
    op.local_seq = __shfl_sync(kFull, col[F_LOCAL_SEQ], src);
    op.msn = __shfl_sync(kFull, col[F_MSN], src);
    apply_one<kRuns>(w, a, (orow + t) * kRunK, op, count, min_seq, seq,
                     overflow);
  }
  __syncwarp();

  store_table(w.S, w.stride, a, doc, w.lane, 32);
  if (w.lane == 0) {
    a.out_count[doc] = count;
    a.out_min_seq[doc] = min_seq;
    a.out_seq[doc] = seq;
    a.out_overflow[doc] = overflow ? 1 : 0;
    if (kExtract) {  // _kernel's last-step narrow outputs
      a.ex_overflow[doc] = static_cast<int16_t>(overflow ? 1 : 0);
      a.ex_count[doc] = count;
      a.ex_min_seq[doc] = min_seq;
      a.ex_seq[doc] = seq;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class Kernel>
cudaError_t launch(Kernel kern, const Args& a, int grid, int threads,
                   size_t smem, cudaStream_t stream) {
  // All of the SM's unified L1 / shared memory as shared memory: the
  // tables live there, and it decides how many documents share an SM.
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (grid > 0 && a.capacity > 0) kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kRuns, bool kExtract>
cudaError_t launch_warp(const Args& a, int docs, size_t smem,
                        cudaStream_t st) {
  const int grid = (a.batch + docs - 1) / docs;
  const int threads = 32 * docs;
  int rows = 1;  // the kernel's kR: the table's rows rounded up to 2^n
  while (rows * 32 < a.capacity) rows <<= 1;
  switch (rows) {
    case 1: return launch(fused_apply_kernel_warp<1, kRuns, kExtract>, a,
                          grid, threads, smem, st);
    case 2: return launch(fused_apply_kernel_warp<2, kRuns, kExtract>, a,
                          grid, threads, smem, st);
    case 4: return launch(fused_apply_kernel_warp<4, kRuns, kExtract>, a,
                          grid, threads, smem, st);
    case 8: return launch(fused_apply_kernel_warp<8, kRuns, kExtract>, a,
                          grid, threads, smem, st);
    case 16: return launch(fused_apply_kernel_warp<16, kRuns, kExtract>, a,
                           grid, threads, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

static int block_threads(int capacity) {
  return std::min(((capacity + 31) / 32) * 32, kMaxThreads);
}

// Dynamic shared memory of one block on each path; the Python wrapper's
// launch_geometry and max_fused_capacity use the same formulas.
static size_t block_smem_bytes(int capacity, int k_slots, int a_slots) {
  const size_t planes = SEG_PLANES + k_slots + a_slots + 2;  // + cum, vis
  return (planes * capacity + kScratchInts) * sizeof(int);
}

static size_t warp_smem_bytes(int capacity, int k_slots, int a_slots,
                              int docs) {
  const size_t planes = SEG_PLANES + k_slots + a_slots;
  const size_t rows = (capacity + 31) / 32;
  return docs * planes * rows * 32 * sizeof(int);
}

// ptrs: 14 input DocState pointers, 14 output DocState pointers (DocState
// field order), 10 PackedOps column pointers, then with with_runs the 3
// RunCols pointers (length, seq, op_id), then with extract the 4 narrow
// outputs (overflow int16, count, min_seq, seq). path, docs_per_block,
// threads and smem_bytes are the host's launch geometry; a geometry that
// differs from this file's formulas is refused with cudaErrorInvalidValue
// (nothing is relaunched another way). Returns cudaGetLastError.
extern "C" int fluid_fused_apply(void** ptrs, int batch, int capacity,
                                 int k_slots, int a_slots, int steps,
                                 int with_runs, int extract, int path,
                                 int docs_per_block, int threads,
                                 long long smem_bytes, void* stream) {
  if (k_slots < 1 || k_slots > kMaxK ||
      SEG_PLANES + k_slots + a_slots > kMaxPlanes || a_slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == PATH_WARP) {
    if (capacity > 32 * kMaxRows || docs_per_block < 1 ||
        docs_per_block > kMaxDocsPerBlock || threads != 32 * docs_per_block ||
        smem_bytes != static_cast<long long>(warp_smem_bytes(
            capacity, k_slots, a_slots, docs_per_block)))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (path == PATH_BLOCK) {
    if (docs_per_block != 1 || threads != block_threads(capacity) ||
        smem_bytes != static_cast<long long>(
            block_smem_bytes(capacity, k_slots, a_slots)))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  int i = 0;
  for (int p = 0; p < SEG_PLANES - 2; ++p)  // length .. rem_local_seq
    a.in_seg[p] = static_cast<const int*>(ptrs[i++]);
  a.in_rc = static_cast<const int*>(ptrs[i++]);
  a.in_seg[ORIGIN_OP] = static_cast<const int*>(ptrs[i++]);
  a.in_seg[ORIGIN_OFF] = static_cast<const int*>(ptrs[i++]);
  a.in_anno = static_cast<const int*>(ptrs[i++]);
  a.in_count = static_cast<const int*>(ptrs[i++]);
  a.in_min_seq = static_cast<const int*>(ptrs[i++]);
  a.in_seq = static_cast<const int*>(ptrs[i++]);
  a.in_overflow = static_cast<const uint8_t*>(ptrs[i++]);
  for (int p = 0; p < SEG_PLANES - 2; ++p)
    a.out_seg[p] = static_cast<int*>(ptrs[i++]);
  a.out_rc = static_cast<int*>(ptrs[i++]);
  a.out_seg[ORIGIN_OP] = static_cast<int*>(ptrs[i++]);
  a.out_seg[ORIGIN_OFF] = static_cast<int*>(ptrs[i++]);
  a.out_anno = static_cast<int*>(ptrs[i++]);
  a.out_count = static_cast<int*>(ptrs[i++]);
  a.out_min_seq = static_cast<int*>(ptrs[i++]);
  a.out_seq = static_cast<int*>(ptrs[i++]);
  a.out_overflow = static_cast<uint8_t*>(ptrs[i++]);
  for (int f = 0; f < N_OP_FIELDS; ++f)
    a.op[f] = static_cast<const int*>(ptrs[i++]);
  a.run_len = a.run_seq = a.run_id = nullptr;
  if (with_runs) {
    a.run_len = static_cast<const int*>(ptrs[i++]);
    a.run_seq = static_cast<const int*>(ptrs[i++]);
    a.run_id = static_cast<const int*>(ptrs[i++]);
  }
  a.ex_overflow = nullptr;
  a.ex_count = a.ex_min_seq = a.ex_seq = nullptr;
  if (extract) {
    a.ex_overflow = static_cast<int16_t*>(ptrs[i++]);
    a.ex_count = static_cast<int*>(ptrs[i++]);
    a.ex_min_seq = static_cast<int*>(ptrs[i++]);
    a.ex_seq = static_cast<int*>(ptrs[i++]);
  }
  a.batch = batch;
  a.capacity = capacity;
  a.k_slots = k_slots;
  a.a_slots = a_slots;
  a.steps = steps;

  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (path == PATH_WARP) {
    const int docs = docs_per_block;
    if (with_runs && extract)
      err = launch_warp<true, true>(a, docs, smem, st);
    else if (with_runs)
      err = launch_warp<true, false>(a, docs, smem, st);
    else if (extract)
      err = launch_warp<false, true>(a, docs, smem, st);
    else
      err = launch_warp<false, false>(a, docs, smem, st);
  } else {
    const int thr = block_threads(capacity);
    if (with_runs && extract)
      err = launch(fused_apply_kernel_block<true, true>, a, batch, thr, smem,
                   st);
    else if (with_runs)
      err = launch(fused_apply_kernel_block<true, false>, a, batch, thr, smem,
                   st);
    else if (extract)
      err = launch(fused_apply_kernel_block<false, true>, a, batch, thr, smem,
                   st);
    else
      err = launch(fused_apply_kernel_block<false, false>, a, batch, thr,
                   smem, st);
  }
  return static_cast<int>(err);
}
