// Last-write-wins lanes: [B, T] op streams applied to B slot tables in one
// launch.
//
// Replaces: fluidframework_tpu/server/lww_kernel.py, _scan (a jitted
//   lax.scan of _apply_one over T, vmap over lanes), which XLA compiles
//   into the serving window's one program. Each op of each lane is applied
//   exactly as _apply_one does it: SET takes the first slot holding its
//   key, else the first free slot (key -1), and writes key, val and seq
//   there; with neither it sets overflow. DELETE frees every slot holding
//   its key (key and val to -1; the slot keeps its seq). CLEAR frees every
//   slot. ADD adds delta to the counter (int32, wrapping). last_seq takes
//   the max with the op's seq on every op of kinds 1-4 and on no other.
//   The admit mode is the serving window's LWW bucket
//   (server/serve_step.py, lww_one): each op's seq is gathered from the
//   ticket plane by (doc_idx, t_idx) with JAX's index rule (a negative
//   index counts from the end, then clamps into range), an op whose seq
//   is <= 0 or whose kind is NOOP becomes a NOOP with seq 0, the admitted
//   kinds are written out, and so is each lane's occupancy (slots with
//   key >= 0) after the window.
//
// Bound on the H100: the serial chain. A lane's ops depend on each other
//   through its table, so each lane takes T steps in series, each a sweep
//   of its C slots; the bytes (the [B, C] table read and written once,
//   20 B an op in) are microseconds at 3.35 TB/s.
//
// Design: one warp per lane, four lanes a block, the T loop inside. The
//   table is copied once into the output buffers and worked on there:
//   lane l of the warp owns slots l, l + 32, ..., so no thread reads a
//   slot another wrote and no barrier is needed. The op columns are
//   loaded 32 steps at a time, lane j holding step t0 + j (coalesced),
//   and broadcast with __shfl_sync at each step. SET's first match and
//   first free come from a __ballot_sync per 32-slot strip and __ffs; the
//   sweep stops at the first strip with a match. Every value but the
//   slots is the same in all 32 lanes, so every branch is warp-uniform.
//   The inputs are not written: the lane store retries an overflowed lane
//   from them.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // lanes per block
enum { kNoop = 0, kSet = 1, kDelete = 2, kClear = 3, kAdd = 4 };

struct LwwArgs {
  // the state in: [B, C] tables, [B] scalars, [B] bool
  const int* key;
  const int* val;
  const int* seq;
  const int* counter;
  const int* last_seq;
  const unsigned char* overflow;
  // the ops: [B, T] columns; op_seq is null in the admit mode
  const int* op_kind;
  const int* op_key;
  const int* op_val;
  const int* op_delta;
  const int* op_seq;
  // admit mode only: [B, T] indices into the [rows, cols] ticket plane
  const int* doc_idx;
  const int* t_idx;
  const int* plane;
  // the state out, same shapes
  int* key_out;
  int* val_out;
  int* seq_out;
  int* counter_out;
  int* last_out;
  unsigned char* overflow_out;
  // admit mode only: [B, T] admitted kinds, [B] occupancy
  int* kind_out;
  int* occ_out;
  int batch;
  int capacity;
  int steps;
  int rows;
  int cols;
};

// JAX's gather index rule: negative counts from the end, then clamp.
__device__ __forceinline__ int jax_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(32 * kWarps) lww_scan_kernel(LwwArgs a) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= a.batch) return;  // uniform per warp
  const int cap = a.capacity;
  const long long row = static_cast<long long>(b) * cap;
  const long long orow = static_cast<long long>(b) * a.steps;
  int* key = a.key_out + row;
  int* val = a.val_out + row;
  int* sq = a.seq_out + row;
  for (int k = lane; k < cap; k += 32) {
    key[k] = a.key[row + k];
    val[k] = a.val[row + k];
    sq[k] = a.seq[row + k];
  }
  unsigned counter = static_cast<unsigned>(a.counter[b]);
  int last = a.last_seq[b];
  bool overflow = a.overflow[b] != 0;
  const bool admit = a.plane != nullptr;

  for (int t0 = 0; t0 < a.steps; t0 += 32) {
    // lane j holds step t0 + j of each column
    const int tl = t0 + lane;
    const bool have = tl < a.steps;
    int kind_l = have ? a.op_kind[orow + tl] : kNoop;
    const int key_l = have ? a.op_key[orow + tl] : 0;
    const int val_l = have ? a.op_val[orow + tl] : 0;
    const int delta_l = have ? a.op_delta[orow + tl] : 0;
    int seq_l = 0;
    if (have) {
      if (admit) {
        const int d = jax_index(a.doc_idx[orow + tl], a.rows);
        const int s = jax_index(a.t_idx[orow + tl], a.cols);
        const int got = a.plane[static_cast<long long>(d) * a.cols + s];
        const bool ok = kind_l != kNoop && got > 0;
        kind_l = ok ? kind_l : kNoop;
        seq_l = ok ? got : 0;
        a.kind_out[orow + tl] = kind_l;
      } else {
        seq_l = a.op_seq[orow + tl];
      }
    }
    const int n = min(32, a.steps - t0);
    for (int j = 0; j < n; ++j) {
      const int kind = __shfl_sync(kFull, kind_l, j);
      const int okey = __shfl_sync(kFull, key_l, j);
      const int oval = __shfl_sync(kFull, val_l, j);
      const int delta = __shfl_sync(kFull, delta_l, j);
      const int oseq = __shfl_sync(kFull, seq_l, j);
      if (kind == kSet) {
        int first_match = -1, first_free = -1;
        for (int base = 0; base < cap; base += 32) {
          const int k = base + lane;
          const bool in = k < cap;
          const int kk = in ? key[k] : 0;
          const unsigned m = __ballot_sync(kFull, in && kk == okey);
          const unsigned f = __ballot_sync(kFull, in && kk == -1);
          if (m != 0u) {
            first_match = base + __ffs(static_cast<int>(m)) - 1;
            break;
          }
          if (first_free < 0 && f != 0u)
            first_free = base + __ffs(static_cast<int>(f)) - 1;
        }
        const int target = first_match >= 0 ? first_match : first_free;
        if (target < 0) {
          overflow = true;
        } else if ((target & 31) == lane) {
          key[target] = okey;
          val[target] = oval;
          sq[target] = oseq;
        }
      } else if (kind == kDelete) {
        for (int k = lane; k < cap; k += 32) {
          if (key[k] == okey) {
            key[k] = -1;
            val[k] = -1;
          }
        }
      } else if (kind == kClear) {
        for (int k = lane; k < cap; k += 32) {
          key[k] = -1;
          val[k] = -1;
        }
      } else if (kind == kAdd) {
        counter += static_cast<unsigned>(delta);
      }
      if (kind >= kSet && kind <= kAdd) last = max(last, oseq);
    }
  }

  if (admit) {
    unsigned occ = 0;
    for (int k = lane; k < cap; k += 32) occ += key[k] >= 0 ? 1u : 0u;
    occ = __reduce_add_sync(kFull, occ);
    if (lane == 0) a.occ_out[b] = static_cast<int>(occ);
  }
  if (lane == 0) {
    a.counter_out[b] = static_cast<int>(counter);
    a.last_out[b] = last;
    a.overflow_out[b] = overflow;
  }
}

}  // namespace

// ptrs, in order: key, val, seq, counter, last_seq, overflow (the state
// in); kind, key, val, delta, seq ([B, T] op columns; seq null in the
// admit mode); doc_idx, t_idx, plane (the admit mode's gather; all null
// otherwise); key, val, seq, counter, last_seq, overflow (the state out);
// kind, occupancy (the admit mode's outputs; null otherwise). `rows` and
// `cols` are the ticket plane's shape. A shape the kernel does not take
// (B or C below 1, T below 0, an empty plane in the admit mode) is
// refused with cudaErrorInvalidValue and nothing runs. Returns
// cudaGetLastError.
extern "C" int fluid_lww_scan(void** ptrs, int batch, int capacity,
                              int steps, int rows, int cols, void* stream) {
  const bool admit = ptrs[13] != nullptr;
  if (batch < 1 || capacity < 1 || steps < 0 ||
      (admit && (rows < 1 || cols < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  LwwArgs a;
  a.key = static_cast<const int*>(ptrs[0]);
  a.val = static_cast<const int*>(ptrs[1]);
  a.seq = static_cast<const int*>(ptrs[2]);
  a.counter = static_cast<const int*>(ptrs[3]);
  a.last_seq = static_cast<const int*>(ptrs[4]);
  a.overflow = static_cast<const unsigned char*>(ptrs[5]);
  a.op_kind = static_cast<const int*>(ptrs[6]);
  a.op_key = static_cast<const int*>(ptrs[7]);
  a.op_val = static_cast<const int*>(ptrs[8]);
  a.op_delta = static_cast<const int*>(ptrs[9]);
  a.op_seq = static_cast<const int*>(ptrs[10]);
  a.doc_idx = static_cast<const int*>(ptrs[11]);
  a.t_idx = static_cast<const int*>(ptrs[12]);
  a.plane = static_cast<const int*>(ptrs[13]);
  a.key_out = static_cast<int*>(ptrs[14]);
  a.val_out = static_cast<int*>(ptrs[15]);
  a.seq_out = static_cast<int*>(ptrs[16]);
  a.counter_out = static_cast<int*>(ptrs[17]);
  a.last_out = static_cast<int*>(ptrs[18]);
  a.overflow_out = static_cast<unsigned char*>(ptrs[19]);
  a.kind_out = static_cast<int*>(ptrs[20]);
  a.occ_out = static_cast<int*>(ptrs[21]);
  a.batch = batch;
  a.capacity = capacity;
  a.steps = steps;
  a.rows = rows;
  a.cols = cols;
  const int grid = (batch + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  lww_scan_kernel<<<grid, 32 * kWarps, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
