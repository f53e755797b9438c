"""fluidframework_tpu_torch — the PyTorch + CUDA port of fluidframework_tpu.

The JAX package (`fluidframework_tpu`) stays the reference; this package
re-implements its device paths in PyTorch, with every Pallas kernel on a
ported path replaced by a CUDA kernel written by hand for Hopper
(`sm_90a`). Module names follow the JAX package so each counterpart is
easy to find:

  core/device.py          device resolution ("cuda" unless the caller asks
                          for the CPU; never a silent fallback)
  core/errors.py          BulkApplyUnsupported
  mergetree/constants.py  sentinels, sequence constants, segment kinds
  mergetree/state.py      DocState segment tables as int32 tensors;
                          state_from_numpy (one document or a batch)
  mergetree/oppack.py     PackedOps op columns (pure numpy packer)
  mergetree/pallas_ops.py summary_lengths + its CUDA kernel
  mergetree/pallas_apply.py  the fused whole-stream apply (plain, runs=,
                          extract=True) + its CUDA kernel
  mergetree/paging.py     page allocator and paged lane store
  mergetree/kernel.py     the scan apply at any capacity (apply_ops*,
                          + its CUDA kernel), zamboni compaction,
                          visible_mask / doc_length, page gather / scatter
  mergetree/host.py       payload tables, OpBuilder, host extraction
  mergetree/runs.py       stable-id Run payloads and their wire encoding
  mergetree/oracle.py     Items payloads (the scalar oracle is not ported)
  mergetree/catchup.py    one document's bulk catch-up: device_apply_tail,
                          apply_host_ops (seed, chunked scan, fold)
  server/ticket_kernel.py deli ticketing, batched over documents
  server/lww_kernel.py    LWW lanes (map / cell / counter)
  server/pipeline.py      full_step: ticket -> fused apply -> summary length
  server/serve_step.py    serving windows and the paged serving megakernel
  telemetry/device_stats.py  the serving stats plane's slot layout
  telemetry/counters.py   named counters (the catch-up's subset)
  kernels/                nvcc build of csrc/*.cu and the ctypes bindings
  interop.py              numpy <-> tensor converters for the conformance tests
  testing/                seeded traces (incl. keystroke_trace) and serving
                          rings, golden JAX outputs

Wrappers run the CUDA kernel for CUDA tensors and the plain PyTorch version
only for CPU tensors. The package imports neither `jax` nor
`fluidframework_tpu`.
"""

__version__ = "0.1.0"
