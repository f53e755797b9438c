// The fused apply with the capacity axis sharded over sp: each document's
// segment table cut into sp tiles, one per block of a thread-block
// cluster, the lane context crossing the tiles through distributed shared
// memory.
//
// Replaces: fluidframework_tpu/mergetree/fused_sp.py:166
//   apply_ops_fused_shardmap (the shard_map body over [B/dp, C/sp] tiles,
//   its lane context shard_lanes at :112), an XLA program in JAX; with it
//   the two-level scan of fluidframework_tpu/parallel/seq_scan.py:24
//   sharded_cumsum as the apply uses it. (The one-device form, :100
//   apply_ops_fused_sp, is scan_apply.cu's: its sp_shards only names the
//   prefix sums' formulation, the same integer sum.) What it computes is
//   _apply_one_batched for op t = 0..T-1 of every document, in both of the
//   variants the JAX sp forms have: plain and INSERT_RUN (kRuns); every
//   lane of every tile (the padding past count too), the overflow flag and
//   the per-document scalars end bit-identical to the JAX result.
//
// Layout. Each document is one cluster of n = sp blocks (n <= 8 is
// portable, up to 16 takes the non-portable attribute; n = 1 launches
// without the cluster attribute, a cluster of one block). Rank j holds
// the slots [j Cs, (j + 1) Cs), Cs = C / n, of every plane in its own
// shared memory, as scan_apply.cu's cluster path does. The tiles are read
// and written where they lie, through a table in device memory of one
// pointer per (plane, rank), in and out: each tile is its own [B/dp, Cs]
// tensor (rem_clients and anno [B/dp, Cs, K] and [B/dp, Cs, A]). One
// launch per dp row, on that row's device; every tile of the row gets its
// copy of the per-document scalars (P('dp'): one per grid entry), all
// read from the row's first.
// No gather to a [B, C] table and no scatter back happen around the
// launch. The tile is loaded with cp.async, as fused_apply.cu's table is.
//
// The lane context of shard_lanes over distributed shared memory (the
// primitives are scan_apply.cu's Live<SCAN_CLUSTER>, included below):
// - any_lane, first_true and masked_scalar (psum / pmin in JAX): each rank
//   publishes its block's partials in its own shared memory, one
//   barrier.cluster, then every rank reads all n partials through
//   map_shared_rank (scan_apply.cu combine);
// - cumsum_excl (the all-gathered two-level scan): a block scan of the
//   tile plus the sum of the totals of the ranks before it
//   (combine_scan); the same integer sum, whatever the blocking;
// - roll_many (the batched ppermute of the boundary rows): the first kBy
//   slots of rank j read the top kBy slots of rank j - 1 into a staging
//   area before the cluster barrier that lets any rank write
//   (shift_right). JAX's wrap into rank 0 from the last rank is always
//   overwritten by the fills, so rank 0 reads nothing;
// - the per-document scalars (count, seq, min_seq, overflow) evolve alike
//   in every rank, as the psum'd copies do in JAX.
// The rest is scan_apply.cu's, and through it fused_apply.cu's per-slot
// rules and apply_one: one view pass per op, sweeps cut at the live rows
// when every plane's padding holds one value, integer adds that wrap as
// int32 does. It is built without tuning the rank count or the threads.
//
// Bound on the H100. Bytes: the state is read once and written once,
// (8 + K + A) int32 planes and four scalars per document, and the op
// columns (and run columns) are read once: 28.6 MB at the long-document
// wave (B = 16, C = 16,384, K = 3, A = 2, T = 2,048), 8.5 us at 3.35 TB/s
// (chip_smoke.py fused_apply_bytes). Operations: every op costs each row
// in use a few dozen integer operations (visibility and prefix sum,
// boundary tests, shifts of all planes; chip_smoke.py
// fused_apply_lane_ops over live_slots counts them from the run's data),
// at the card's integer rate of 16.7e12/s. Over the rows in use the
// operations bound it. A document's ops are a chain of dependent steps
// and each step joins the n blocks of its cluster several times (one
// barrier.cluster per combine and per shift that crosses a rank), so what
// a launch costs is that chain: the passes per op, their length over a
// tile, and the cluster barriers.

#define FLUID_SCAN_LIVE_ONLY
#include "scan_apply.cu"
#undef FLUID_SCAN_LIVE_ONLY

namespace {

// The leaves of a tile: the 8 segment planes (Plane order), rem_clients,
// anno; and the per-document scalars each tile holds a copy of.
constexpr int kLeaves = SEG_PLANES + 2;
enum SpScalar { SC_COUNT = 0, SC_MIN_SEQ, SC_SEQ, SC_OVERFLOW, N_SCALARS };

struct SpArgs {
  Args a;  // the shape, the op and run columns, the input scalars
  // In device memory: in tiles [kLeaves][n], out tiles [kLeaves][n], then
  // the output scalars [N_SCALARS][n], as addresses.
  const unsigned long long* tiles;
};

__device__ __forceinline__ int* tile_ptr(const SpArgs& s, int leaf, int n,
                                         int rank) {
  return reinterpret_cast<int*>(s.tiles[leaf * n + rank]);
}

// This rank's slots of document doc, between its tiles (the input with
// kLoad, by cp.async, complete for this thread on return; else the output)
// and the planar shared-memory table (plane stride Cs).
template <bool kLoad>
__device__ void tile_rows(const Live<SCAN_CLUSTER>& d, const SpArgs& s,
                          long long doc) {
  const int m = d.hi - d.lo;
  if (m <= 0) return;
  const int n = d.nrank;
  const int side = kLoad ? 0 : kLeaves;
  const long long row = doc * d.Cs;
  for (int p = 0; p < SEG_PLANES; ++p) {
    int* g = tile_ptr(s, side + p, n, d.rank) + row;
    for (int i = d.tid; i < m; i += d.nthr) {
      if constexpr (kLoad)
        __pipeline_memcpy_async(d.S + p * d.Cs + i, g + i, sizeof(int));
      else
        g[i] = d.S[p * d.Cs + i];
    }
  }
  copy_interleaved<kLoad>(d.S + SEG_PLANES * d.Cs, d.Cs,
                          tile_ptr(s, side + SEG_PLANES, n, d.rank) +
                              row * d.K,
                          m, d.K, d.tid, d.nthr);
  copy_interleaved<kLoad>(d.S + (SEG_PLANES + d.K) * d.Cs, d.Cs,
                          tile_ptr(s, side + SEG_PLANES + 1, n, d.rank) +
                              row * d.A,
                          m, d.A, d.tid, d.nthr);
  if constexpr (kLoad) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
}

// One document per cluster.
template <bool kRuns>
__global__ void __launch_bounds__(kScanThreads) fused_sp_kernel(SpArgs s) {
  extern __shared__ int smem[];
  const Args& a = s.a;
  Live<SCAN_CLUSTER> d;
  init_live(d, a);
  shared_table(d, smem);
  const long long doc = blockIdx.x / d.nrank;
  tile_rows<true>(d, s, doc);
  __syncthreads();
  d.cluster_sync();  // every rank loaded (and running) before any reads it

  int count = a.in_count[doc];
  int min_seq = a.in_min_seq[doc];
  int seq = a.in_seq[doc];
  bool overflow = a.in_overflow[doc] != 0;
  run_ops<kRuns>(d, a, doc, count, min_seq, seq, overflow);

  tile_rows<false>(d, s, doc);
  if (d.tid == 0) {
    const unsigned long long* sc = s.tiles + 2 * kLeaves * d.nrank;
    const int c = d.nrank;
    reinterpret_cast<int*>(sc[SC_COUNT * c + d.rank])[doc] = count;
    reinterpret_cast<int*>(sc[SC_MIN_SEQ * c + d.rank])[doc] = min_seq;
    reinterpret_cast<int*>(sc[SC_SEQ * c + d.rank])[doc] = seq;
    reinterpret_cast<uint8_t*>(sc[SC_OVERFLOW * c + d.rank])[doc] =
        overflow ? 1 : 0;
  }
  d.cluster_sync();  // no block leaves while another may read its memory
}

}  // namespace

// ptrs: the input scalars (count, min_seq, seq int32, overflow bool; [B],
// the copy every rank reads), the 10 PackedOps columns ([B, T] int32),
// then with with_runs the 3 RunCols columns ([B, T, RUN_K]). tiles: a
// device array of (2 x 10 + 4) x blocks addresses as above. B documents
// of capacity C in clusters of `blocks` (1..16) blocks, C a multiple of
// blocks; threads a multiple of 32 in 32..512; smem_bytes scan_apply.cu's
// shared_table_bytes(C, 8 + K + A, blocks), at most 227 KB. K outside
// 1..8, A < 1, C < 1, (8 + K + A) x C >= 2^31 or any other geometry is
// refused with cudaErrorInvalidValue. Returns the launch's error.
extern "C" int fluid_fused_sp(void** ptrs, const void* tiles, int batch,
                              int capacity, int k_slots, int a_slots,
                              int steps, int with_runs, int blocks,
                              int threads, long long smem_bytes,
                              void* stream) {
  const long long planes = SEG_PLANES + static_cast<long long>(k_slots) +
                           a_slots;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (k_slots < 1 || k_slots > kMaxK || a_slots < 1 || capacity < 1 ||
      batch < 0 || steps < 0 || planes * capacity >= (1LL << 31) ||
      blocks < 1 || blocks > kMaxCluster ||
      static_cast<long long>(batch) * blocks >= (1LL << 31) ||
      capacity % blocks != 0 || tiles == nullptr)
    return bad;
  if (threads < 32 ||
      threads > kScanThreads || threads % 32 != 0 ||
      smem_bytes > kSmemLimit ||
      smem_bytes != shared_table_bytes(capacity, planes, blocks))
    return bad;
  SpArgs s;
  s.a = Args{};
  int i = 0;
  s.a.in_count = static_cast<const int*>(ptrs[i++]);
  s.a.in_min_seq = static_cast<const int*>(ptrs[i++]);
  s.a.in_seq = static_cast<const int*>(ptrs[i++]);
  s.a.in_overflow = static_cast<const uint8_t*>(ptrs[i++]);
  for (int f = 0; f < N_OP_FIELDS; ++f)
    s.a.op[f] = static_cast<const int*>(ptrs[i++]);
  if (with_runs) {
    s.a.run_len = static_cast<const int*>(ptrs[i++]);
    s.a.run_seq = static_cast<const int*>(ptrs[i++]);
    s.a.run_id = static_cast<const int*>(ptrs[i++]);
  }
  s.a.batch = batch;
  s.a.capacity = capacity;
  s.a.k_slots = k_slots;
  s.a.a_slots = a_slots;
  s.a.steps = steps;
  s.tiles = static_cast<const unsigned long long*>(tiles);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      with_runs ? launch_scan(fused_sp_kernel<true>, s, blocks, threads,
                              smem, true, st)
                : launch_scan(fused_sp_kernel<false>, s, blocks, threads,
                              smem, true, st));
}
