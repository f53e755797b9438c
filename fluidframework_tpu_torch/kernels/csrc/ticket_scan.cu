// Deli ticketing of [B, T] message streams in one launch.
//
// Replaces: fluidframework_tpu/server/ticket_kernel.py, _scan_tickets (a
//   jitted lax.scan of _ticket_one over T, vmap over documents). Each
//   message of each document is ticketed exactly as _ticket_one does it:
//   the leave first, then the slot (the first matching client, else the
//   first free slot, else slot 0, argmax's rule), the duplicate drop
//   before the stale-ref nack, auto-join or the not-joined nack, the
//   JOIN's ref at next_seq - 1 (a JOIN into a full table still takes a
//   seq and sets overflow), and the MSN as the masked min of the active
//   clients' refs (INT32_MAX sentinel), monotone and clamped to
//   next_seq - 1. empty_after is read after the message's update.
//
// Bound on the H100: the serial chain. A document's messages depend on
//   each other through its client table, so each document takes T steps
//   of a few warp-wide votes and shuffles in series; the bytes (23 B a
//   message at K = 8: three int32 in, two int32 and three bools out, plus
//   the [B, K] table read and written once) are a few microseconds at
//   3.35 TB/s. The card hides one document's chain behind the other
//   resident warps' chains.
//
// Design: one warp per document, eight documents per block. Lane l holds
//   client slots l, l + 32, ... (kS = ceil(K / 32) registers of each
//   table column, K <= 32 * kMaxS); a slot past K holds the id INT32_MIN,
//   which is never free (-1), never active (>= 0) and never a client
//   (>= 0). The op columns are loaded 32 steps at a time, lane j holding
//   step t0 + j (coalesced), and broadcast with __shfl_sync at each step;
//   "which slot matches / is free" is a __ballot_sync per register and
//   __ffs, the heap min a __reduce_min_sync, taken only when the message
//   is ticketed. Step t0 + j's results stay in lane j, so the [B, T]
//   outputs are stored coalesced, the bools as bytes. The new table goes
//   to new tensors: the inputs are not written. Every value but the
//   table's columns is the same in all 32 lanes (warp-uniform branches).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;
constexpr int kNoSlot = -0x7fffffff - 1;  // the id of a slot past K
constexpr int kMaxS = 4;                  // K <= 128
constexpr int kWarps = 8;                 // documents per block
enum { kNoop = 0, kOp = 1, kJoin = 2, kLeave = 3, kSystem = 4 };

struct TicketArgs {
  // the state in: [B, K] table columns, [B] scalars, [B] bool
  const int* ids;
  const int* ref;
  const int* cseq;
  const int* next_seq;
  const int* min_seq;
  const unsigned char* overflow;
  // the messages: [B, T]; kind may be null (every client >= 0 is an OP)
  const int* client;
  const int* client_seq;
  const int* ref_seq;
  const int* kind;
  // the state out, same shapes
  int* ids_out;
  int* ref_out;
  int* cseq_out;
  int* next_out;
  int* min_out;
  unsigned char* overflow_out;
  // per message: [B, T]
  int* seq;
  int* msn;
  unsigned char* nacked;
  unsigned char* not_joined;
  unsigned char* empty_after;
  int batch;
  int steps;
  int slots;
  int require_join;
};

// int32 +1 / -1 that wrap as torch's and XLA's int32 do.
__device__ __forceinline__ int inc(int x) {
  return static_cast<int>(static_cast<unsigned>(x) + 1u);
}
__device__ __forceinline__ int dec(int x) {
  return static_cast<int>(static_cast<unsigned>(x) - 1u);
}

// The first slot (r * 32 + lane, for bit `lane` of bits[r]) whose bit is
// set, or -1.
template <int kS>
__device__ __forceinline__ int first_slot(const unsigned (&bits)[kS]) {
  int out = -1;
#pragma unroll
  for (int r = kS - 1; r >= 0; --r)
    if (bits[r] != 0u) out = r * 32 + __ffs(static_cast<int>(bits[r])) - 1;
  return out;
}

// Whether any of this lane's slots holds an active client (id >= 0).
template <int kS>
__device__ __forceinline__ bool any_active(const int (&ids)[kS]) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < kS; ++r) any |= ids[r] >= 0;
  return any;
}

template <int kS>
__global__ void __launch_bounds__(32 * kWarps) ticket_scan_kernel(
    TicketArgs a) {
  const int doc = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (doc >= a.batch) return;  // uniform per warp
  const long long srow = static_cast<long long>(doc) * a.slots;
  const long long orow = static_cast<long long>(doc) * a.steps;

  int ids[kS], ref[kS], cs[kS];
#pragma unroll
  for (int r = 0; r < kS; ++r) {
    const int k = r * 32 + lane;
    const bool in = k < a.slots;
    ids[r] = in ? a.ids[srow + k] : kNoSlot;
    ref[r] = in ? a.ref[srow + k] : kIntMax;
    cs[r] = in ? a.cseq[srow + k] : 0;
  }
  int next = a.next_seq[doc];
  int min_seq = a.min_seq[doc];
  bool overflow = a.overflow[doc] != 0;
  bool empty = !__any_sync(kFull, any_active(ids));

  for (int t0 = 0; t0 < a.steps; t0 += 32) {
    // lane j holds step t0 + j of each column
    const int tl = t0 + lane;
    const bool have = tl < a.steps;
    const int client_l = have ? a.client[orow + tl] : -1;
    const int cseq_l = have ? a.client_seq[orow + tl] : 0;
    const int rseq_l = have ? a.ref_seq[orow + tl] : 0;
    const int kind_l = !have ? kNoop
                       : a.kind != nullptr ? a.kind[orow + tl]
                       : (client_l >= 0 ? kOp : kNoop);
    int o_seq = 0, o_msn = 0;
    bool o_nack = false, o_nj = false, o_empty = false;
    const int n = min(32, a.steps - t0);
    for (int j = 0; j < n; ++j) {
      const int kind = __shfl_sync(kFull, kind_l, j);
      const int client = __shfl_sync(kFull, client_l, j);
      const int cseq = __shfl_sync(kFull, cseq_l, j);
      const int rseq = __shfl_sync(kFull, rseq_l, j);
      const bool has_client = client >= 0;
      const bool is_op = kind == kOp && has_client;
      const bool is_join = kind == kJoin && has_client;
      const bool is_leave = kind == kLeave && has_client;
      const bool is_system = kind == kSystem;

      // Leave first: evict the client from the MSN calculation.
      bool leave_ok = false;
      if (is_leave) {
        bool gone = false;
#pragma unroll
        for (int r = 0; r < kS; ++r) {
          if (ids[r] == client) {
            ids[r] = -1;
            ref[r] = kIntMax;
            gone = true;
          }
        }
        leave_ok = __any_sync(kFull, gone);
      }

      // The slot: the first matching client, else the first free one,
      // else 0 (known and have_free matter only to an OP or a JOIN).
      bool known = false, have_free = false;
      int slot = 0, prev_cseq = 0;
      if (is_op || is_join) {
        unsigned match[kS], free_bits[kS];
#pragma unroll
        for (int r = 0; r < kS; ++r) {
          match[r] = __ballot_sync(kFull, ids[r] == client);
          free_bits[r] = __ballot_sync(kFull, ids[r] == -1);
        }
        const int first_match = first_slot(match);
        const int first_free = first_slot(free_bits);
        known = first_match >= 0;
        have_free = first_free >= 0;
        slot = known ? first_match : (have_free ? first_free : 0);
        if (known) {
          int mine = cs[0];
#pragma unroll
          for (int r = 1; r < kS; ++r)
            if (r == (slot >> 5)) mine = cs[r];
          prev_cseq = __shfl_sync(kFull, mine, slot & 31);
        }
      }

      const bool auto_join =
          is_op && !known && have_free && a.require_join == 0;
      const bool active = (is_op && known) || auto_join;
      // The dup check wins over the stale-refSeq nack.
      const bool dup = is_op && known && cseq <= prev_cseq;
      const bool stale = is_op && rseq < min_seq && !dup;
      const bool not_joined = is_op && !active;
      const bool nacked = stale || not_joined;
      const bool op_ticket = is_op && !dup && !nacked;
      const bool join_ok = is_join && (known || have_free);
      const bool join_full = is_join && !known && !have_free;

      if (op_ticket || join_ok) {
#pragma unroll
        for (int r = 0; r < kS; ++r) {
          if (r * 32 + lane == slot) {
            ids[r] = client;
            ref[r] = op_ticket ? rseq : dec(next);
            cs[r] = op_ticket ? cseq : 0;
          }
        }
      }
      if (leave_ok || op_ticket || join_ok)
        empty = !__any_sync(kFull, any_active(ids));

      const bool ticket =
          op_ticket || join_ok || join_full || leave_ok || is_system;
      const int seq = ticket ? next : 0;
      if (ticket) {
        // MSN: min over active clients' refSeqs, monotone, clamped below
        // the just-assigned seq.
        int heap = kIntMax;
#pragma unroll
        for (int r = 0; r < kS; ++r)
          if (ids[r] >= 0) heap = min(heap, ref[r]);
        heap = __reduce_min_sync(kFull, heap);
        int msn = heap == kIntMax ? min_seq : max(min_seq, heap);
        min_seq = min(msn, dec(next));
        next = inc(next);
      }
      overflow = overflow || join_full;
      if (lane == j) {
        o_seq = seq;
        o_msn = min_seq;
        o_nack = nacked;
        o_nj = not_joined;
        o_empty = empty;
      }
    }
    if (have) {
      a.seq[orow + tl] = o_seq;
      a.msn[orow + tl] = o_msn;
      a.nacked[orow + tl] = o_nack;
      a.not_joined[orow + tl] = o_nj;
      a.empty_after[orow + tl] = o_empty;
    }
  }

#pragma unroll
  for (int r = 0; r < kS; ++r) {
    const int k = r * 32 + lane;
    if (k < a.slots) {
      a.ids_out[srow + k] = ids[r];
      a.ref_out[srow + k] = ref[r];
      a.cseq_out[srow + k] = cs[r];
    }
  }
  if (lane == 0) {
    a.next_out[doc] = next;
    a.min_out[doc] = min_seq;
    a.overflow_out[doc] = overflow;
  }
}

template <int kS>
cudaError_t launch(const TicketArgs& a, cudaStream_t stream) {
  const int grid = (a.batch + kWarps - 1) / kWarps;
  ticket_scan_kernel<kS><<<grid, 32 * kWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ptrs, in order: ids, ref, cseq, next_seq, min_seq, overflow (the state
// in); client, client_seq, ref_seq, kind (null without a kind column);
// ids, ref, cseq, next_seq, min_seq, overflow (the state out); seq, msn,
// nacked, not_joined, empty_after. A shape the kernel does not take
// (K outside 1..128, B or T below 1) is refused with
// cudaErrorInvalidValue and nothing runs. Returns cudaGetLastError.
extern "C" int fluid_ticket_scan(void** ptrs, int batch, int steps,
                                 int slots, int require_join, void* stream) {
  if (slots < 1 || slots > 32 * kMaxS || batch < 1 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TicketArgs a;
  a.ids = static_cast<const int*>(ptrs[0]);
  a.ref = static_cast<const int*>(ptrs[1]);
  a.cseq = static_cast<const int*>(ptrs[2]);
  a.next_seq = static_cast<const int*>(ptrs[3]);
  a.min_seq = static_cast<const int*>(ptrs[4]);
  a.overflow = static_cast<const unsigned char*>(ptrs[5]);
  a.client = static_cast<const int*>(ptrs[6]);
  a.client_seq = static_cast<const int*>(ptrs[7]);
  a.ref_seq = static_cast<const int*>(ptrs[8]);
  a.kind = static_cast<const int*>(ptrs[9]);
  a.ids_out = static_cast<int*>(ptrs[10]);
  a.ref_out = static_cast<int*>(ptrs[11]);
  a.cseq_out = static_cast<int*>(ptrs[12]);
  a.next_out = static_cast<int*>(ptrs[13]);
  a.min_out = static_cast<int*>(ptrs[14]);
  a.overflow_out = static_cast<unsigned char*>(ptrs[15]);
  a.seq = static_cast<int*>(ptrs[16]);
  a.msn = static_cast<int*>(ptrs[17]);
  a.nacked = static_cast<unsigned char*>(ptrs[18]);
  a.not_joined = static_cast<unsigned char*>(ptrs[19]);
  a.empty_after = static_cast<unsigned char*>(ptrs[20]);
  a.batch = batch;
  a.steps = steps;
  a.slots = slots;
  a.require_join = require_join;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((slots + 31) / 32) {
    case 1: return static_cast<int>(launch<1>(a, st));
    case 2: return static_cast<int>(launch<2>(a, st));
    case 3: return static_cast<int>(launch<3>(a, st));
    default: return static_cast<int>(launch<4>(a, st));
  }
}
