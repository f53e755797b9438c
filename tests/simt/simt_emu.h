// A SIMT emulator that runs a CUDA C++ kernel source on the CPU, for the
// conformance tests of the port's hand-written kernels
// (tests/test_torch_fused_emu.py). It is not a CUDA implementation: it
// provides only what fused_apply.cu uses, and no timing means anything.
//
// Every CUDA thread of a block is a ucontext coroutine. A thread runs until
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
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct EmuDim { unsigned x, y, z; };
// A set of threads that meet at a barrier: a warp or the block.
struct EmuGroup {
  int size = 0;
  int count = 0;
  unsigned gen = 0;
  int64_t vals[1024];
};
struct EmuThread {
  ucontext_t ctx;
  EmuDim tidx;
  bool done;
  std::vector<char> stack;
};
struct EmuCopy { void* dst; const void* src; size_t n; };

inline EmuThread* emu_cur;
inline ucontext_t emu_sched;
inline EmuDim emu_block_idx, emu_block_dim;
inline EmuGroup emu_warps[32];
inline EmuGroup emu_block;
inline int* emu_smem;
inline std::mt19937 emu_rng(12345);
inline std::vector<EmuCopy> emu_pending[1024];

#define threadIdx (emu_cur->tidx)
#define blockIdx (emu_block_idx)
#define blockDim (emu_block_dim)

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
inline EmuGroup& emu_warp() { return emu_warps[threadIdx.x >> 5]; }
inline void emu_full(unsigned mask) {
  if (mask != 0xffffffffu) abort();  // only full-warp masks are modelled
}

template <class T> T __ldg(const T* p) { return *p; }
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
inline int __any_sync(unsigned m, int p) {
  return emu_reduce(m, p != 0, [](int a, int b) { return a | b; });
}
inline int __all_sync(unsigned m, int p) {
  return emu_reduce(m, p != 0, [](int a, int b) { return a & b; });
}
inline void __syncwarp(unsigned m = 0xffffffffu) {
  emu_full(m);
  emu_barrier(emu_warp());
}
inline void __syncthreads() { emu_barrier(emu_block); }
inline int __syncthreads_or(int p) {
  EmuGroup& g = emu_block;
  g.vals[threadIdx.x] = p != 0;
  emu_barrier(g);
  int r = 0;
  for (int i = 0; i < g.size; ++i) r |= static_cast<int>(g.vals[i]);
  emu_barrier(g);
  return r;
}

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  emu_pending[threadIdx.x].push_back({dst, src, n});
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {
  auto& q = emu_pending[threadIdx.x];
  for (const EmuCopy& c : q) memcpy(c.dst, c.src, c.n);
  q.clear();
}

template <class K, class A> struct EmuCall {
  static inline K kern;
  static inline A* args;
  static void entry() {
    kern(*args);
    emu_cur->done = true;
  }
};

// kern<<<grid, threads, smem>>>(a), one block after another.
template <class K, class A>
void emu_launch(K kern, int grid, int threads, size_t smem, A a) {
  EmuCall<K, A>::kern = kern;
  EmuCall<K, A>::args = &a;
  std::vector<int> shared(smem / sizeof(int) + 1);
  std::vector<EmuThread> th(threads);
  std::vector<int> order(threads);
  for (int b = 0; b < grid; ++b) {
    for (int& x : shared) x = static_cast<int>(emu_rng());
    emu_smem = shared.data();
    emu_block_idx = EmuDim{static_cast<unsigned>(b), 0, 0};
    emu_block_dim = EmuDim{static_cast<unsigned>(threads), 1, 1};
    for (int w = 0; w < (threads + 31) / 32; ++w)
      emu_warps[w] = EmuGroup{32, 0, 0, {}};
    emu_block.size = threads;
    emu_block.count = 0;
    for (int t = 0; t < threads; ++t) {
      EmuThread& e = th[t];
      e.done = false;
      e.tidx = EmuDim{static_cast<unsigned>(t), 0, 0};
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
