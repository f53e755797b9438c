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
//   result. The variants are template parameters (kRuns, kExtract), so the
//   plain variant's code is what it was before they existed.
//
// Bound on the H100. Bytes: the state is read once and written once,
// (8 + K + A) int32 planes plus four scalars per document, and the ten op
// columns are read once. At B=10,000, C=256, K=3, A=1, T=100 that is
// 2 x 123 MB + 40 MB = 0.29 GB, about 85 us at 3.35 TB/s. Operations: each
// op costs every slot a few dozen integer operations (visibility predicate,
// prefix sum, masks, shifts of all planes), about 4e10 at that shape, which
// is about 0.6 ms at the table's 67 T/s non-tensor rate (chip_smoke.py
// counts them from the run's op kinds). So operations bound it, and in
// practice so do the block-wide barriers: every op needs a prefix sum and
// one or two block reductions and structural shifts, each of which ends in
// __syncthreads(), about fifteen barriers per op.
//
// The INSERT_RUN variant adds, on run steps only, one visibility pass, a
// shift of every plane by RUN_K = 8 and 8 row fills: the same barriers as
// one plain insert for up to 8 inserts. The extract variant adds four [B]
// stores per document after the last op.
//
// Design, in answer to that bound:
// - One block per document (grid = B), one thread per segment slot
//   (blockDim = C rounded up to 32, at most 1024; chunk loops cover
//   C > 1024). Blocks are independent, so nothing crosses the grid.
// - All (8 + K + A) planes, plus the per-op prefix sum and visibility
//   planes, stay in dynamic shared memory for the whole op stream
//   ((10 + K + A) x C x 4 B; 14 KB at the bench shape): device memory is
//   touched once on the way in and once on the way out, the "2 state
//   passes" of the TPU kernel. Small blocks let up to eight documents share
//   an SM, so one block's barrier stall is hidden by the others.
// - rem_clients / anno are read in their [B, C, K] / [B, C, A] layout and
//   written back the same way: no plane copies outside the kernel.
// - Block primitives: the exclusive prefix sum is a warp-shuffle scan plus
//   per-warp totals; first_true / masked sums are one fused reduction
//   (__reduce_min_sync / __reduce_add_sync, then per-warp partials);
//   any_lane is __syncthreads_or; the shift right reads lane-by into
//   registers, barriers, and writes back. Per-op scalars (count, seq,
//   min_seq, overflow) are block-uniform registers.
// - The run shift moves lanes >= slot + 8 from lane - 8. JAX rolls
//   cyclically over lanes >= slot, but lanes [slot, slot + 8) are then
//   overwritten on every plane by the fills, so no wrapped value survives
//   and the kernel never reads across the end of the table. A fill indexes
//   its member directly by rel = lane - slot (JAX's 8-term select). Run
//   member lengths are >= 0 (RunCols: 0 marks padding); a fill treats
//   length 0 as a dead row and > 0 as a live one, as JAX does.
// - Integer adds wrap in unsigned arithmetic as int32 does in JAX, and no
//   comparison widens the INT32_MAX-1 / INT32_MAX sentinels.

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

enum OpKindCode { NOOP = 0, INSERT = 1, REMOVE = 2, ANNOTATE = 3,
                  ACK_INSERT = 4, ACK_REMOVE = 5, INSERT_RUN = 6 };
enum Plane { LEN = 0, INS_SEQ, INS_CLIENT, LOCAL_SEQ, REM_SEQ,
             REM_LOCAL_SEQ, ORIGIN_OP, ORIGIN_OFF, SEG_PLANES };
enum OpField { F_KIND = 0, F_SEQ, F_REF_SEQ, F_CLIENT, F_POS1, F_POS2,
               F_OP_ID, F_NEW_LEN, F_LOCAL_SEQ, F_MSN, N_OP_FIELDS };

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
  int capacity, k_slots, a_slots, steps;
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

struct Blk {
  int* S;      // [P][C] segment planes
  int* cum;    // [C] exclusive prefix sum of visible lengths
  int* vis;    // [C] visibility
  int* red;    // [96] per-warp reduction partials
  int* scan;   // [32] per-warp scan totals
  int C, K, A, P, nthr, tid, warp, lane, nwarps;

  __device__ int& at(int p, int l) { return S[p * C + l]; }
  __device__ int& rc(int i, int l) { return S[(SEG_PLANES + i) * C + l]; }
  __device__ int& an(int i, int l) { return S[(SEG_PLANES + K + i) * C + l]; }
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
      const bool inserted = b.at(INS_SEQ, l) <= ref || b.at(INS_CLIENT, l) == client;
      bool removed = b.at(REM_SEQ, l) <= ref;
      for (int i = 0; i < b.K; ++i) removed |= b.rc(i, l) == client;
      vis = (l < count) && inserted && !removed;
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
  for (int l = b.tid; l < b.C; l += b.nthr) {
    const bool in_run = b.cum[l] == op.pos1;
    const bool tomb = b.at(REM_SEQ, l) <= op.ref_seq;
    const bool acked_ins = b.at(INS_SEQ, l) != kUnassigned;
    const bool stop = in_run && (b.vis[l] || (!tomb && (is_local || acked_ins))
                                 || l >= count);
    if (stop) mn = min(mn, l);
  }
  mn = reduce_min(b, mn);
  if (mn >= b.C) {  // no tie-break slot: flagged, state unchanged
    overflow = true;
    return;
  }
  const int slot = mn;
  shift_right<1>(b, max(slot, 1));  // lane 0 is overwritten below
  count += 1;
  for (int p = b.tid; p < b.P; p += b.nthr) {
    int v = -1;  // rem_clients and anno slots
    switch (p) {
      case LEN: v = op.new_len; break;
      case INS_SEQ: v = op.seq; break;
      case INS_CLIENT: v = op.client; break;
      case LOCAL_SEQ: v = is_local ? op.local_seq : 0; break;
      case REM_SEQ: v = kNoRemove; break;
      case REM_LOCAL_SEQ: v = 0; break;
      case ORIGIN_OP: v = op.op_id; break;
      case ORIGIN_OFF: v = 0; break;
      default: break;
    }
    b.S[p * b.C + slot] = v;
  }
  __syncthreads();
}

// pallas_apply._insert_run_phase (vis/cum hold the post-boundary view): the
// members of run row `run` ([kRunK] in each RunCols column) land as
// contiguous rows at the first member's tie-break slot.
__device__ void insert_run_phase(Blk& b, const Args& a, long long run,
                                 const Op& op, int& count, bool& overflow) {
  int mn = b.C;
  for (int l = b.tid; l < b.C; l += b.nthr) {
    const bool in_run = b.cum[l] == op.pos1;
    const bool tomb = b.at(REM_SEQ, l) <= op.ref_seq;
    const bool acked_ins = b.at(INS_SEQ, l) != kUnassigned;
    const bool stop = in_run && (b.vis[l] || (!tomb && acked_ins) ||
                                 l >= count);
    if (stop) mn = min(mn, l);
  }
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
    const int len = __ldg(a.run_len + run + rel);
    const bool live = len > 0;
    int v = -1;  // rem_clients and anno slots
    switch (p) {
      case LEN: v = len; break;
      case INS_SEQ: v = live ? __ldg(a.run_seq + run + rel) : 0; break;
      case INS_CLIENT: v = live ? op.client : -1; break;
      case LOCAL_SEQ: v = 0; break;
      case REM_SEQ: v = live ? kNoRemove : 0; break;
      case REM_LOCAL_SEQ: v = 0; break;
      case ORIGIN_OP: v = __ldg(a.run_id + run + rel); break;
      case ORIGIN_OFF: v = 0; break;
      default: break;
    }
    b.S[p * b.C + l] = v;
  }
  __syncthreads();
}

// pallas_apply._append_overlap on one lane's overlap slots: the client goes
// into the first slot >= 1 that was free.
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

__device__ __forceinline__ bool range_target(Blk& b, int l, const Op& op) {
  if (!b.vis[l]) return false;
  const int c = b.cum[l];
  const int len = b.at(LEN, l);
  return len > 0 && c >= op.pos1 && wadd(c, len) <= op.pos2;
}

// pallas_apply._remove_phase: per lane, then one any-lane overflow vote.
__device__ void remove_phase(Blk& b, const Op& op, bool& overflow) {
  const bool is_local = op.seq == kUnassigned;
  int over = 0;
  for (int l = b.tid; l < b.C; l += b.nthr) {
    if (!range_target(b, l, op)) continue;
    const int rs = b.at(REM_SEQ, l);
    const bool fresh = rs == kNoRemove;
    const bool pend = rs == kUnassigned && !is_local;
    const bool already = rs != kNoRemove && !pend;
    if (fresh) {
      b.at(REM_SEQ, l) = is_local ? kUnassigned : op.seq;
      if (is_local) b.at(REM_LOCAL_SEQ, l) = op.local_seq;
    } else if (pend) {
      b.at(REM_SEQ, l) = op.seq;
      b.at(REM_LOCAL_SEQ, l) = 0;
    }
    int rc[kMaxK];
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if (i < b.K) rc[i] = b.rc(i, l);
    const int prior = rc[0];
    if (fresh || pend) rc[0] = op.client;
    const bool displaced = pend && prior != op.client;
    append_overlap(rc, b.K, displaced, prior);
    bool has_client = false;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if (i < b.K) has_client |= rc[i] == op.client;
    const bool need = already && !has_client;
    append_overlap(rc, b.K, need, op.client);
    const int want = displaced ? prior : op.client;
    bool landed = false;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if (i < b.K) landed |= rc[i] == want;
    if ((displaced || need) && !landed) over = 1;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if (i < b.K) b.rc(i, l) = rc[i];
  }
  if (__syncthreads_or(over)) overflow = true;
}

// pallas_apply._annotate_phase: push op_id onto each target's ring.
__device__ void annotate_phase(Blk& b, const Op& op, bool& overflow) {
  int over = 0;
  for (int l = b.tid; l < b.C; l += b.nthr) {
    if (!range_target(b, l, op)) continue;
    if (b.an(b.A - 1, l) != -1) over = 1;
    for (int i = b.A - 1; i > 0; --i) b.an(i, l) = b.an(i - 1, l);
    b.an(0, l) = op.op_id;
  }
  if (__syncthreads_or(over)) overflow = true;
}

// pallas_apply._ack_phase: every lane, padding included.
__device__ void ack_phase(Blk& b, const Op& op) {
  for (int l = b.tid; l < b.C; l += b.nthr) {
    if (op.kind == ACK_INSERT && b.at(INS_SEQ, l) == kUnassigned &&
        b.at(LOCAL_SEQ, l) == op.local_seq) {
      b.at(INS_SEQ, l) = op.seq;
      b.at(LOCAL_SEQ, l) = 0;
    }
    if (op.kind == ACK_REMOVE && b.at(REM_SEQ, l) == kUnassigned &&
        b.at(REM_LOCAL_SEQ, l) == op.local_seq) {
      b.at(REM_SEQ, l) = op.seq;
      b.at(REM_LOCAL_SEQ, l) = 0;
    }
  }
}

// pallas_apply._apply_one_batched for one document. Only the phase of the
// op's kind runs: the others are identities on their disabled masks. `run`
// is the op's row offset into the RunCols columns (kRuns only).
template <bool kRuns>
__device__ void apply_one(Blk& b, const Args& a, long long run, const Op& op,
                          int& count, int& min_seq, int& seq, bool& overflow) {
  const int kind = op.kind;
  const bool is_run = kRuns && kind == INSERT_RUN;
  bool is_edit = kind == INSERT || kind == REMOVE || kind == ANNOTATE ||
                 is_run;
  bool is_range = kind == REMOVE || kind == ANNOTATE;
  const bool fits = count + (is_run ? kRunK + 1 : 2) <= b.C;
  if (is_edit && !fits) overflow = true;
  is_edit = is_edit && fits;
  is_range = is_range && fits;
  if (is_edit) ensure_boundary(b, op.pos1, op.ref_seq, op.client, count);
  if (is_range) ensure_boundary(b, op.pos2, op.ref_seq, op.client, count);
  if (is_edit) {
    visibility(b, op.ref_seq, op.client, count);
    if (kind == INSERT) insert_phase(b, op, count, overflow);
    else if (is_run) insert_run_phase(b, a, run, op, count, overflow);
    else if (kind == REMOVE) remove_phase(b, op, overflow);
    else annotate_phase(b, op, overflow);
  }
  if (kind == ACK_INSERT || kind == ACK_REMOVE) ack_phase(b, op);
  if (kind != NOOP && op.seq != kUnassigned) {
    seq = max(seq, op.seq);
    min_seq = max(min_seq, op.msn);
  }
}

template <bool kRuns, bool kExtract>
__global__ void __launch_bounds__(kMaxThreads) fused_apply_kernel(Args a) {
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
  const long long row = doc * b.C;
  for (int p = 0; p < SEG_PLANES; ++p)
    for (int l = b.tid; l < b.C; l += b.nthr) b.at(p, l) = a.in_seg[p][row + l];
  for (int e = b.tid; e < b.C * b.K; e += b.nthr)
    b.rc(e % b.K, e / b.K) = a.in_rc[row * b.K + e];
  for (int e = b.tid; e < b.C * b.A; e += b.nthr)
    b.an(e % b.A, e / b.A) = a.in_anno[row * b.A + e];
  int count = a.in_count[doc];
  int min_seq = a.in_min_seq[doc];
  int seq = a.in_seq[doc];
  bool overflow = a.in_overflow[doc] != 0;
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

  for (int p = 0; p < SEG_PLANES; ++p)
    for (int l = b.tid; l < b.C; l += b.nthr) a.out_seg[p][row + l] = b.at(p, l);
  for (int e = b.tid; e < b.C * b.K; e += b.nthr)
    a.out_rc[row * b.K + e] = b.rc(e % b.K, e / b.K);
  for (int e = b.tid; e < b.C * b.A; e += b.nthr)
    a.out_anno[row * b.A + e] = b.an(e % b.A, e / b.A);
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

template <bool kRuns, bool kExtract>
cudaError_t launch(const Args& a, int batch, size_t smem,
                   cudaStream_t stream) {
  auto kern = fused_apply_kernel<kRuns, kExtract>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = std::min(((a.capacity + 31) / 32) * 32, kMaxThreads);
  if (batch > 0 && a.capacity > 0) kern<<<batch, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block; the Python wrapper's
// max_fused_capacity inverts the same formula against 227 KB.
static size_t smem_bytes(int capacity, int k_slots, int a_slots) {
  const size_t planes = SEG_PLANES + k_slots + a_slots + 2;  // + cum, vis
  return (planes * capacity + kScratchInts) * sizeof(int);
}

// ptrs: 14 input DocState pointers, 14 output DocState pointers (DocState
// field order), 10 PackedOps column pointers, then with with_runs the 3
// RunCols pointers (length, seq, op_id), then with extract the 4 narrow
// outputs (overflow int16, count, min_seq, seq). Returns cudaGetLastError.
extern "C" int fluid_fused_apply(void** ptrs, int batch, int capacity,
                                 int k_slots, int a_slots, int steps,
                                 int with_runs, int extract, void* stream) {
  if (k_slots < 1 || k_slots > kMaxK ||
      SEG_PLANES + k_slots + a_slots > kMaxPlanes || a_slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.capacity = capacity;
  a.k_slots = k_slots;
  a.a_slots = a_slots;
  a.steps = steps;

  const size_t smem = smem_bytes(capacity, k_slots, a_slots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_runs && extract) err = launch<true, true>(a, batch, smem, st);
  else if (with_runs) err = launch<true, false>(a, batch, smem, st);
  else if (extract) err = launch<false, true>(a, batch, smem, st);
  else err = launch<false, false>(a, batch, smem, st);
  return static_cast<int>(err);
}
