// The serving window's merge admission: one group's staged op columns ->
// the ops its apply takes, in one launch.
//
// Replaces: the admission block of fluidframework_tpu/server/
//   serve_step.py, _serve_window_impl (the merge loop's gathers and masks,
//   which XLA fuses into the window's one program; the port's plain
//   version is server/serve_step.admit_merge_ops_plain). Each op takes the
//   seq and msn its ticket step was assigned, gathered from the [rows,
//   cols] ticket planes by (doc_idx, t_idx) with JAX's index rule (a
//   negative index counts from the end, then clamps into range); an op
//   whose kind is NOOP or whose seq is <= 0 becomes a NOOP with seq and
//   msn 0. With run columns, each INSERT_RUN member (length > 0) gathers
//   its own seq (0 for the padding members), and a member whose seq is
//   <= 0 voids the whole slot (a NOOP) and flags the lane in over_extra.
//
// Bound on the H100: bytes. The kind and index columns (and the run
//   columns) are read once, the two planes gathered (L2-resident: 80 B a
//   document at T = 16 x 2), and three columns written: 24 B an op
//   without runs; microseconds at 3.35 TB/s.
//
// Design: one warp per lane, four lanes a block; thread j of the warp
//   takes steps j, j + 32, ... of its lane, so every column is read and
//   written coalesced. over_extra is the warp's __any_sync over its
//   steps. Only kind, seq and msn (and the runs' seq) are written: the
//   other PackedOps columns are the staged columns as they are, which the
//   wrapper passes on as views.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // lanes per block
constexpr int kNoop = 0;
constexpr int kInsertRun = 6;

struct AdmitArgs {
  const int* seq_plane;  // [rows, cols]
  const int* msn_plane;  // [rows, cols]
  const int* mc;         // [12, lanes, steps]: kind at row 0, doc_idx 10, t_idx 11
  const int* mr;         // [4, lanes, steps, run_k] or null
  int* kind;             // [lanes, steps]
  int* seq;
  int* msn;
  int* run_seq;                // [lanes, steps, run_k] or null
  unsigned char* over_extra;   // [lanes] or null
  int lanes;
  int steps;
  int run_k;
  int rows;
  int cols;
};

// JAX's gather index rule: negative counts from the end, then clamp.
__device__ __forceinline__ int jax_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ long long plane_at(const AdmitArgs& a, int d,
                                              int t) {
  return static_cast<long long>(jax_index(d, a.rows)) * a.cols +
         jax_index(t, a.cols);
}

__global__ void __launch_bounds__(32 * kWarps) window_admit_kernel(
    AdmitArgs a) {
  const int l = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (l >= a.lanes) return;  // uniform per warp
  const long long plane = static_cast<long long>(a.lanes) * a.steps;
  const long long row = static_cast<long long>(l) * a.steps;
  bool any_mispredict = false;
  for (int t = lane; t < a.steps; t += 32) {
    const long long at = row + t;
    const int kind = a.mc[at];
    const long long g = plane_at(a, a.mc[10 * plane + at],
                                 a.mc[11 * plane + at]);
    const int seq_g = a.seq_plane[g];
    const int msn_g = a.msn_plane[g];
    bool ok = kind != kNoop && seq_g > 0;
    if (a.mr != nullptr) {
      const long long rplane = plane * a.run_k;
      bool voided = false;
      for (int k = 0; k < a.run_k; ++k) {
        const long long m = at * a.run_k + k;
        const bool expected = a.mr[m] > 0;
        const int sub = a.seq_plane[plane_at(a, a.mr[2 * rplane + m],
                                             a.mr[3 * rplane + m])];
        a.run_seq[m] = expected ? sub : 0;
        voided = voided || (expected && sub <= 0);
      }
      const bool mispredict = kind == kInsertRun && voided;
      ok = ok && !mispredict;
      any_mispredict = any_mispredict || mispredict;
    }
    a.kind[at] = ok ? kind : kNoop;
    a.seq[at] = ok ? seq_g : 0;
    a.msn[at] = ok ? msn_g : 0;
  }
  if (a.mr != nullptr) {
    const bool over = __any_sync(kFull, any_mispredict);
    if (lane == 0) a.over_extra[l] = over;
  }
}

}  // namespace

// ptrs, in order: seq plane, msn plane ([rows, cols] ticket results), mc
// ([12, lanes, steps] staged columns), mr ([4, lanes, steps, run_k] run
// columns, or null); kind, seq, msn ([lanes, steps] admitted columns),
// run seq ([lanes, steps, run_k]) and over_extra ([lanes] bool), the last
// two null without run columns. A shape the kernel does not take (lanes,
// steps, rows or cols below 1, run_k below 1 with run columns) is refused
// with cudaErrorInvalidValue and nothing runs. Returns cudaGetLastError.
extern "C" int fluid_window_admit(void** ptrs, int lanes, int steps,
                                  int run_k, int rows, int cols,
                                  void* stream) {
  const bool runs = ptrs[3] != nullptr;
  if (lanes < 1 || steps < 1 || rows < 1 || cols < 1 ||
      (runs && run_k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  AdmitArgs a;
  a.seq_plane = static_cast<const int*>(ptrs[0]);
  a.msn_plane = static_cast<const int*>(ptrs[1]);
  a.mc = static_cast<const int*>(ptrs[2]);
  a.mr = static_cast<const int*>(ptrs[3]);
  a.kind = static_cast<int*>(ptrs[4]);
  a.seq = static_cast<int*>(ptrs[5]);
  a.msn = static_cast<int*>(ptrs[6]);
  a.run_seq = static_cast<int*>(ptrs[7]);
  a.over_extra = static_cast<unsigned char*>(ptrs[8]);
  a.lanes = lanes;
  a.steps = steps;
  a.run_k = run_k;
  a.rows = rows;
  a.cols = cols;
  const int grid = (lanes + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  window_admit_kernel<<<grid, 32 * kWarps, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
