// A SIMT emulator that runs a CUDA C++ kernel source on the CPU, for the
// conformance tests of the port's hand-written kernels
// (tests/test_torch_fused_emu.py, tests/test_torch_scan_emu.py,
// tests/test_torch_ticket_emu.py, tests/test_torch_summary_emu.py,
// tests/test_torch_lww_emu.py, tests/test_torch_window_emu.py,
// tests/test_torch_zamboni_emu.py). It is
// not a CUDA implementation: it provides only what the kernels of
// fluidframework_tpu_torch/kernels/csrc/ use, and no timing means
// anything. The device it reports has EMU_SMS multiprocessors, each
// holding one block of any kernel.
//
// Every CUDA thread of a block is a ucontext coroutine; the blocks of one
// thread-block cluster run together under one scheduler, each with its own
// shared memory, and cooperative_groups' this_cluster() gives their
// cluster barrier and map_shared_rank. A thread runs until
// it reaches a warp or block primitive; the primitives are barriers that
// exchange values, so a thread that reads another thread's shared memory
// without a barrier between the write and the read sees whatever the
// scheduler left there. The scheduler resumes the threads in a shuffled
// order (a fixed seed), shared memory starts as random words, and a
// cp.async copy lands only when its thread waits for it, so a missing
// barrier or wait shows as a wrong result.
#pragma once
#include <stddef.h>
#include <stdint.h>
#include <ucontext.h>

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

constexpr int EMU_SMS = 2;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *v = EMU_SMS;
  return cudaSuccess;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}

struct int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

struct EmuDim { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
// A set of threads that meet at a barrier: a warp, a block or a cluster.
struct EmuGroup {
  int size = 0;
  int count = 0;
  unsigned gen = 0;
  int64_t vals[1024];
};
struct EmuCopy { void* dst; const void* src; size_t n; };
// One block: its index, its rank in its cluster, its own shared memory
// (random words at launch) and its warps' and its own barriers.
struct EmuBlock {
  EmuDim idx;
  int rank;
  std::vector<int> shared;
  EmuGroup warps[32];
  EmuGroup block;
};
struct EmuThread {
  ucontext_t ctx;
  EmuDim tidx;
  bool done;
  std::vector<char> stack;
  EmuBlock* blk;
  std::vector<EmuCopy> pending;  // cp.async copies not yet waited for
};

inline EmuThread* emu_cur;
inline ucontext_t emu_sched;
inline EmuDim blockDim;  // every block of a launch has the same
inline EmuDim gridDim;
inline std::vector<EmuBlock> emu_blocks;  // the running cluster's blocks
inline EmuGroup emu_cluster;              // all of their threads
inline size_t emu_smem_bytes;
inline std::mt19937 emu_rng(12345);

#define threadIdx (emu_cur->tidx)
#define blockIdx (emu_cur->blk->idx)
#define emu_smem (emu_cur->blk->shared.data())

inline void emu_yield() { swapcontext(&emu_cur->ctx, &emu_sched); }
inline void emu_barrier(EmuGroup& g) {
  const unsigned gen = g.gen;
  if (++g.count == g.size) {
    g.count = 0;
    g.gen++;
  } else {
    while (g.gen == gen) emu_yield();
  }
}
inline int emu_lane() { return threadIdx.x & 31; }
inline EmuGroup& emu_warp() { return emu_cur->blk->warps[threadIdx.x >> 5]; }
inline void emu_full(unsigned mask) {
  if (mask != 0xffffffffu) abort();  // only full-warp masks are modelled
}

template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> T __shfl_sync(unsigned m, T v, int src) {
  emu_full(m);
  EmuGroup& g = emu_warp();
  g.vals[emu_lane()] = static_cast<int64_t>(v);
  emu_barrier(g);
  const T r = static_cast<T>(g.vals[src & 31]);
  emu_barrier(g);
  return r;
}
template <class T> T __shfl_up_sync(unsigned m, T v, int d) {
  emu_full(m);
  EmuGroup& g = emu_warp();
  const int l = emu_lane();
  g.vals[l] = static_cast<int64_t>(v);
  emu_barrier(g);
  const T r = l >= d ? static_cast<T>(g.vals[l - d]) : v;
  emu_barrier(g);
  return r;
}
// The value of op over the 32 lanes' v (every lane gets it).
template <class T, class Op> T emu_reduce(unsigned m, T v, Op op) {
  emu_full(m);
  EmuGroup& g = emu_warp();
  g.vals[emu_lane()] = static_cast<int64_t>(v);
  emu_barrier(g);
  T r = static_cast<T>(g.vals[0]);
  for (int i = 1; i < 32; ++i) r = op(r, static_cast<T>(g.vals[i]));
  emu_barrier(g);
  return r;
}
inline int __reduce_min_sync(unsigned m, int v) {
  return emu_reduce(m, v, [](int a, int b) { return min(a, b); });
}
inline unsigned __reduce_add_sync(unsigned m, unsigned v) {
  return emu_reduce(m, v, [](unsigned a, unsigned b) { return a + b; });
}
inline int __reduce_max_sync(unsigned m, int v) {
  return emu_reduce(m, v, [](int a, int b) { return max(a, b); });
}
// Atomics: the threads are coroutines of one host thread, and none yields
// inside an atomic, so a plain read-modify-write is atomic. Each yields
// after it, so the other threads' order around it stays shuffled.
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = static_cast<int>(static_cast<unsigned>(old) +
                        static_cast<unsigned>(v));
  emu_yield();
  return old;
}
inline int atomicOr(int* p, int v) {
  const int old = *p;
  *p = old | v;
  emu_yield();
  return old;
}
inline int atomicMax(int* p, int v) {
  const int old = *p;
  *p = max(old, v);
  emu_yield();
  return old;
}
inline void __threadfence() {}
inline int __any_sync(unsigned m, int p) {
  return emu_reduce(m, p != 0, [](int a, int b) { return a | b; });
}
inline int __all_sync(unsigned m, int p) {
  return emu_reduce(m, p != 0, [](int a, int b) { return a & b; });
}
inline unsigned __ballot_sync(unsigned m, int p) {
  emu_full(m);
  EmuGroup& g = emu_warp();
  g.vals[emu_lane()] = p != 0;
  emu_barrier(g);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (g.vals[i]) r |= 1u << i;
  emu_barrier(g);
  return r;
}
inline int __ffs(int x) {
  return x == 0 ? 0 : __builtin_ctz(static_cast<unsigned>(x)) + 1;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncwarp(unsigned m = 0xffffffffu) {
  emu_full(m);
  emu_barrier(emu_warp());
}
inline void __syncthreads() { emu_barrier(emu_cur->blk->block); }
inline int __syncthreads_or(int p) {
  EmuGroup& g = emu_cur->blk->block;
  g.vals[threadIdx.x] = p != 0;
  emu_barrier(g);
  int r = 0;
  for (int i = 0; i < g.size; ++i) r |= static_cast<int>(g.vals[i]);
  emu_barrier(g);
  return r;
}
inline int __syncthreads_and(int p) {
  EmuGroup& g = emu_cur->blk->block;
  g.vals[threadIdx.x] = p != 0;
  emu_barrier(g);
  int r = 1;
  for (int i = 0; i < g.size; ++i) r &= static_cast<int>(g.vals[i]);
  emu_barrier(g);
  return r;
}

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  emu_cur->pending.push_back({dst, src, n});
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {
  auto& q = emu_cur->pending;
  for (const EmuCopy& c : q) memcpy(c.dst, c.src, c.n);
  q.clear();
}

// The thread-block cluster of cooperative_groups: a barrier over every
// thread of every block of the cluster, and a pointer into another
// block's shared memory at the same offset.
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_barrier(emu_cluster); }
  unsigned block_rank() const { return emu_cur->blk->rank; }
  unsigned num_blocks() const { return emu_blocks.size(); }
  template <class T>
  T* map_shared_rank(T* p, int rank) const {
    const char* base =
        reinterpret_cast<const char*>(emu_cur->blk->shared.data());
    const ptrdiff_t off = reinterpret_cast<const char*>(p) - base;
    if (off < 0 || static_cast<size_t>(off) >= emu_smem_bytes ||
        rank < 0 || rank >= static_cast<int>(emu_blocks.size()))
      abort();  // not this block's shared memory, or no such rank
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>(emu_blocks[rank].shared.data()) + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

template <class K, class A> struct EmuCall {
  static inline K kern;
  static inline A* args;
  static void entry() {
    kern(*args);
    emu_cur->done = true;
  }
};

// kern<<<grid, threads, smem>>>(a) in clusters of `cluster` blocks: the
// blocks of one cluster run together, their threads in one shuffled
// order; one cluster after another.
template <class K, class A>
void emu_run(K kern, int grid, int cluster, int threads, size_t smem, A a) {
  EmuCall<K, A>::kern = kern;
  EmuCall<K, A>::args = &a;
  emu_smem_bytes = smem;
  blockDim = EmuDim{static_cast<unsigned>(threads), 1, 1};
  gridDim = EmuDim{static_cast<unsigned>(grid), 1, 1};
  const int n = cluster * threads;
  std::vector<EmuThread> th(n);
  std::vector<int> order(n);
  for (int b0 = 0; b0 < grid; b0 += cluster) {
    emu_blocks.assign(cluster, EmuBlock{});
    for (int r = 0; r < cluster; ++r) {
      EmuBlock& blk = emu_blocks[r];
      blk.idx = EmuDim{static_cast<unsigned>(b0 + r), 0, 0};
      blk.rank = r;
      blk.shared.resize(smem / sizeof(int) + 1);
      for (int& x : blk.shared) x = static_cast<int>(emu_rng());
      for (int w = 0; w < (threads + 31) / 32; ++w)
        blk.warps[w] = EmuGroup{32, 0, 0, {}};
      blk.block.size = threads;
    }
    emu_cluster.size = n;
    emu_cluster.count = 0;
    for (int t = 0; t < n; ++t) {
      EmuThread& e = th[t];
      e.done = false;
      e.blk = &emu_blocks[t / threads];
      e.tidx = EmuDim{static_cast<unsigned>(t % threads), 0, 0};
      e.pending.clear();
      e.stack.resize(1 << 16);
      getcontext(&e.ctx);
      e.ctx.uc_stack.ss_sp = e.stack.data();
      e.ctx.uc_stack.ss_size = e.stack.size();
      e.ctx.uc_link = &emu_sched;
      makecontext(&e.ctx, EmuCall<K, A>::entry, 0);
      order[t] = t;
    }
    for (bool any = true; any;) {
      any = false;
      std::shuffle(order.begin(), order.end(), emu_rng);
      for (int t : order) {
        if (th[t].done) continue;
        any = true;
        emu_cur = &th[t];
        swapcontext(&emu_sched, &th[t].ctx);
      }
    }
  }
}

template <class K, class A>
void emu_launch(K kern, int grid, int threads, size_t smem, A a) {
  emu_run(kern, grid, 1, threads, smem, a);
}

// cudaLaunchKernelEx with the one attribute the kernels use, the cluster
// dimension.
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class A, class B>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kern)(A),
                               B&& b) {
  int cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg->attrs[i].val.clusterDim.x;
  if (cfg->gridDim.x % cluster != 0) return cudaErrorInvalidValue;
  emu_run(kern, cfg->gridDim.x, cluster, cfg->blockDim.x,
          cfg->dynamicSmemBytes, A(b));
  return cudaSuccess;
}
