"""fluidframework_tpu_torch — the PyTorch + CUDA port of fluidframework_tpu.

The JAX package (`fluidframework_tpu`) stays the reference; this package
re-implements its device paths in PyTorch, with every Pallas kernel on a
ported path replaced by a CUDA kernel written by hand for Hopper
(`sm_90a`), as are the merge-tree scan and the deli ticket scan, XLA
loops in JAX. Module names follow the JAX package so each counterpart
is easy to find:

  core/device.py          device resolution ("cuda" unless the caller asks
                          for the CPU; never a silent fallback)
  core/errors.py          BulkApplyUnsupported
  core/events.py          TypedEventEmitter, Deferred
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
                          visible_mask / doc_length, page gather / scatter,
                          the paged ops (apply_ops_paged, rollback_pages,
                          compact_pages, paged_stats_vec), summary
                          extraction (extract_visible_batched, the fused
                          compact_extract_batched / _paged,
                          gather_rows_pow2; compaction and extraction are
                          the zamboni CUDA kernel's modes) and the narrow
                          device-to-host wire (fetch_extracted, its pack
                          a CUDA kernel)
  mergetree/host.py       payload tables, OpBuilder, host extraction,
                          snapshot assembly (assemble_snapshot)
  mergetree/runs.py       stable-id Run payloads and their wire encoding
  mergetree/oracle.py     the scalar merge-tree oracle (MergeTreeOracle,
                          Segment, LocalReference, Items)
  mergetree/client.py     MergeTreeClient (local edits, apply_msg, acks,
                          reconnect, apply_bulk on the device catch-up)
  mergetree/costmodel.py  device_bulk_wins: scalar vs device catch-up
  mergetree/catchup.py    one document's bulk catch-up: device_apply_tail,
                          apply_host_ops (seed, chunked scan, fold); the
                          catch-up narrow wire (pack_entries_narrow)
  protocol/messages.py    wire message types (DocumentMessage, Boxcar, ...)
  server/ticket_kernel.py deli ticketing, batched over documents
                          (scan_tickets + its CUDA kernel)
  server/lww_kernel.py    LWW lanes (map / cell / counter)
  server/pipeline.py      full_step: ticket -> fused apply -> summary length
  server/serve_step.py    serving windows, the paged serving megakernel
                          and the paged burst (serve_paged_burst)
  server/wire.py          JSON wire codecs (boxcar_to_wire, ...)
  server/log.py           the ordered log (MessageLog, topics, partitions)
  server/lambdas/base.py  the lambda SPI (LambdaContext, IPartitionLambda)
  telemetry/device_stats.py  the stats planes' layouts and their fold
                          into counters
  telemetry/counters.py   named counters, gauges, latency histograms, the
                          input-signature probe (JitRetraceProbe)
  telemetry/compile_ledger.py  per-symbol compile attribution (new
                          signatures, the CUDA library build)
  telemetry/tracing.py    op-lifecycle tracing and the flight recorder
  dds/                    the DDSes (SharedString and the other sequences,
                          SharedMatrix, SharedMap, SharedDirectory, the
                          counter, cell, consensus and small DDSes)
  runtime/                ContainerRuntime, DataStoreRuntime (the device
                          hand-off to channels), pending state, summarizer
  loader/                 Loader, Container, DeltaManager and the local
                          driver onto server/local_server.py
  kernels/                nvcc build of csrc/*.cu and the ctypes bindings
  interop.py              numpy <-> tensor converters for the conformance tests
  testing/                seeded traces (incl. keystroke_trace), serving
                          rings (hot documents, backlogs), golden JAX outputs

Wrappers run the CUDA kernel for CUDA tensors and the plain PyTorch version
only for CPU tensors. The package imports neither `jax` nor
`fluidframework_tpu`.
"""

__version__ = "0.1.0"
