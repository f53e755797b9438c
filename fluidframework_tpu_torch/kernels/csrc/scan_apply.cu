// The scan apply: the op stream of each document applied to its segment
// table in device memory, for tables of any capacity.
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
// tests/test_pallas_apply.py), so this kernel is fused_apply.cu's BLOCK
// path run on a table that stays in device memory instead of shared
// memory: the per-slot rules, apply_one and the block primitives are
// fused_apply.cu's own, included below with FLUID_APPLY_RULES_ONLY.
//
// Design (no speed work yet; ROADMAP.md lists what would come next):
// - One block per document, one thread per slot: blockDim = C rounded up
//   to 32, at most kScanThreads = 512, and the block primitives' chunk
//   loops cover C > 512. The table's addresses are 64-bit device
//   addresses, not the fused kernel's 32-bit shared-memory ones, and the
//   op loop then needs more than the 64 registers a thread of a
//   1,024-thread block may hold (ptxas spilled at 1,024 and 768 threads);
//   at 512 threads a thread may hold 128, and none spills.
// - The table lives in a planar work buffer in device memory that the
//   wrapper allocates per launch ([B, P, C] int32, P = 8 + K + A planes,
//   slot l of plane p at p * C + l, the layout of the block path's shared
//   memory). The kernel copies the input state into it, applies every op
//   in place there, and copies it out to the output state, so the input
//   survives (the _keep semantics: an overflow retry re-applies from it).
//   At C = 16,384 a document's 14 planes are 0.9 MB, at 65,536 3.7 MB:
//   they stay in the H100's 50 MB L2.
// - The per-op prefix sum and visibility planes (2 x C ints) sit in shared
//   memory up to kMaxSharedSlots = 28,992 slots, else in a [B, 2, C]
//   device scratch buffer that the wrapper allocates; the 128-int
//   reduction scratch is always in shared memory.
// - The op loop runs inside the kernel: one launch per chunk of ops, not
//   one per op. Each op joins the slots with about fifteen
//   __syncthreads(), which order the work buffer's device-memory writes as
//   they order shared memory.
// - Any A >= 1 (the catch-up doubles the annotate ring up to its chunk
//   length, 512, on an overflow retry) and 1 <= K <= 8; the plane count
//   is not capped, only (8 + K + A) x C < 2^31.
//
// Bound on the H100. Bytes: the state is read once and written once,
// (8 + K + A) int32 planes and four scalars per document, and the op and
// run columns are read once: about 2 MB at B = 1, C = 16,384, K = 3,
// A = 4, T = 512, or 0.6 us at 3.35 TB/s. Operations: every op costs
// every slot of its document about a hundred integer operations
// (visibility and prefix sums, boundary tests, shifts of all planes;
// chip_smoke.py counts them from the run's op kinds), about 1e9 at that
// shape, 60 us at the integer rate (16.7e12/s). So operations bound it.
// One document is one block on one SM, though, and its ops are a chain of
// dependent steps, so a B = 1 launch runs on 1 of the 132 SMs, and what it
// costs is the chain of barriers and device-memory round trips per op.

#define FLUID_APPLY_RULES_ONLY
#include "fused_apply.cu"
#undef FLUID_APPLY_RULES_ONLY

namespace {

constexpr int kSmemLimit = 232448;  // shared memory per block on Hopper
constexpr int kScanThreads = 512;   // threads per block, at most
// The largest C whose prefix-sum and visibility planes fit shared memory
// beside the reduction scratch.
constexpr int kMaxSharedSlots =
    (kSmemLimit - kScratchInts * static_cast<int>(sizeof(int))) /
    (2 * static_cast<int>(sizeof(int)));

struct ScanArgs {
  Args a;
  int* work;     // [B, P, C] planar table
  int* scratch;  // [B, 2, C] prefix sum and visibility, or null (shared)
};

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

template <bool kRuns>
__global__ void __launch_bounds__(kScanThreads) scan_apply_kernel(
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
  }
}

template <class Kernel>
cudaError_t launch_scan(Kernel kern, const ScanArgs& s, int threads,
                        size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (s.a.batch > 0) kern<<<s.a.batch, threads, smem, stream>>>(s);
  return cudaGetLastError();
}

}  // namespace

static int scan_threads(int capacity) {
  return std::min(((capacity + 31) / 32) * 32, kScanThreads);
}

// Dynamic shared memory of one block: the reduction scratch, plus the
// prefix-sum and visibility planes when they fit. The Python wrapper
// (mergetree/kernel.scan_geometry) uses the same formulas.
static size_t scan_smem_bytes(int capacity) {
  const size_t planes = capacity <= kMaxSharedSlots ? 2 : 0;
  return (kScratchInts + planes * capacity) * sizeof(int);
}

// ptrs: as fused_apply.cu's args_from_ptrs takes them without the narrow
// outputs (14 input and 14 output DocState pointers, 10 PackedOps columns,
// with with_runs 3 RunCols columns), then the [B, P, C] work buffer, then
// the [B, 2, C] scratch buffer, which must be null exactly when
// capacity <= kMaxSharedSlots. threads and smem_bytes are the host's
// launch geometry; one that differs from this file's formulas, K outside
// 1..8, A < 1, C < 1 or (8 + K + A) x C >= 2^31 is refused with
// cudaErrorInvalidValue. Returns cudaGetLastError.
extern "C" int fluid_scan_apply(void** ptrs, int batch, int capacity,
                                int k_slots, int a_slots, int steps,
                                int with_runs, int threads,
                                long long smem_bytes, void* stream) {
  const long long planes = SEG_PLANES + static_cast<long long>(k_slots) +
                           a_slots;
  if (k_slots < 1 || k_slots > kMaxK || a_slots < 1 || capacity < 1 ||
      batch < 0 || steps < 0 || planes * capacity >= (1LL << 31) ||
      threads != scan_threads(capacity) ||
      smem_bytes != static_cast<long long>(scan_smem_bytes(capacity)))
    return static_cast<int>(cudaErrorInvalidValue);
  int used = 0;
  ScanArgs s;
  s.a = args_from_ptrs(ptrs, batch, capacity, k_slots, a_slots, steps,
                       with_runs, 0, used);
  s.work = static_cast<int*>(ptrs[used]);
  s.scratch = static_cast<int*>(ptrs[used + 1]);
  if (s.work == nullptr ||
      (s.scratch == nullptr) != (capacity <= kMaxSharedSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      with_runs ? launch_scan(scan_apply_kernel<true>, s, threads, smem, st)
                : launch_scan(scan_apply_kernel<false>, s, threads, smem, st);
  return static_cast<int>(err);
}
