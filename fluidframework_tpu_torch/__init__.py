"""fluidframework_tpu_torch — the PyTorch + CUDA port of fluidframework_tpu.

The JAX package (`fluidframework_tpu`) stays the reference; this package
re-implements its device paths in PyTorch, with every Pallas kernel on a
ported path replaced by a CUDA kernel written by hand for Hopper
(`sm_90a`). Module names follow the JAX package so each counterpart is
easy to find:

  core/device.py          device resolution ("cuda" unless the caller asks
                          for the CPU; never a silent fallback)
  mergetree/state.py      DocState segment tables as int32 tensors
  mergetree/oppack.py     PackedOps op columns (pure numpy packer)
  mergetree/pallas_ops.py summary_lengths + its CUDA kernel
  mergetree/pallas_apply.py  the fused whole-stream apply (plain, runs=,
                          extract=True) + its CUDA kernel
  mergetree/paging.py     page allocator and paged lane store
  mergetree/kernel.py     gather / scatter of documents by page id
  server/ticket_kernel.py deli ticketing, batched over documents
  server/lww_kernel.py    LWW lanes (map / cell / counter)
  server/pipeline.py      full_step: ticket -> fused apply -> summary length
  server/serve_step.py    serving windows and the paged serving megakernel
  telemetry/device_stats.py  the serving stats plane's slot layout
  kernels/                nvcc build of csrc/*.cu and the ctypes bindings
  interop.py              numpy <-> tensor converters for the conformance tests
  testing/                seeded traces and serving rings, golden JAX outputs

Wrappers run the CUDA kernel for CUDA tensors and the plain PyTorch version
only for CPU tensors. The package imports neither `jax` nor
`fluidframework_tpu`.
"""

__version__ = "0.1.0"
