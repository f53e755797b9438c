"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--north-star]

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version (bit-exact: all state is int32/int16/bool), holds the
fused apply, the pipeline step and one serving ring against the JAX outputs
committed in fluidframework_tpu_torch/testing/golden/, then drives the two
main paths through the kernels, checks each against its plain composition
and times it with CUDA events:
  - the north-star step (10,000 docs x 100 ops, capacity 256, ticket table
    K=8): phases 1-5. Phase 2 holds the summary-length kernel bit-exact on
    aligned and misaligned rows; phase 2b holds the ticket-scan kernel
    (kernels/csrc/ticket_scan.cu) bit-exact against scan_tickets_plain
    on a grid of client slots, contracts, steps and batches, two windows
    each; phase 5 times the ticket scan, and the summary length warm and
    cold;
  - the paged serving megakernel: the fused apply's runs= and extract=True
    variants (phase 6), the golden ring (phase 7), and two rings back to
    back of a 10,000-document partition (testing/serving.py FULL_RING:
    8 windows x 16 ticket steps, ~214k merge ops per ring in three page
    groups, 1,000 LWW lanes), the second one timed (phase 8). Each
    window of a ring launches the window's kernels: the merge admission
    (kernels/csrc/window_admit.cu) once a page group, the LWW lane scan
    (kernels/csrc/lww_scan.cu, its admit mode) once an LWW bucket and the
    flat16 pack (kernels/csrc/window_pack.cu) once; the counts must be
    exactly those, and the plain LWW scan may not run on the card's
    tensors. Each of the three is held bit-exact against its plain
    version at ring 2's window 0 and timed by the profiler against its
    bound, and so is the LWW scan on one lane-store bucket of 16,384
    slots.
The fused apply has two paths (one warp or one block per document) that
mergetree/pallas_apply.launch_geometry chooses from the shape: the main
paths must take the path the rule names, both paths are timed at the main
paths' shapes (the rule's may be at most PATH_MARGIN slower), and phase 9
holds both paths in all four variants bit-exact against the plain version
on fuzzed tables and op streams. Each fused-apply row's bound counts the
work of this run's data (the rows in use, live_slots) and, beside it,
every slot of every table.
The scan apply (mergetree/kernel.py over kernels/csrc/scan_apply.cu, any
capacity) has four paths (the table in one block's shared memory, in a
thread-block cluster's, or in device memory, and the first design,
global_chunked) that mergetree/kernel.scan_geometry chooses from the
shape; phase 10 holds every path (each cluster size that holds the
table) bit-exact against the plain scan on a fuzz grid up to C = 65,536,
and against the fused kernel where that applies. Then one document's bulk
catch-up runs at full size (phase 11): the 100,000-op keystroke trace of
BASELINE.json config #2 through mergetree/catchup.device_apply_tail,
every chunk on the rule's path and every fold's compaction one launch
of kernels/csrc/zamboni.cu (no plain compaction on the card's tensors),
held to the JAX golden digest, its first
10,000 ops to the plain composition entry by entry, timed with a
host/device split, and once more with every chunk forced onto
global_chunked; and full_step above the fused capacity (1,024 docs x 100
ops at C = 8,192) against its plain composition. At its three shapes
(the first catch-up chunk at C = 4,096 and at C = 16,384, and full_step)
every path is timed and the rule's may be at most PATH_MARGIN slower than
the fastest; every path is also timed, for the smem path's rows, on two
inputs whose tables fit one block (the C = 4,096 chunk with one annotate
slot, where it must also equal the fused apply, and full_step's ops on
C = 1,024 tables).
Phase 12 is a paged flush with hot documents (testing/serving.py
HOT_RING: FULL_RING's partition plus 64 documents pre-seeded to 3,500
live rows): one megakernel ring, whose hot page group (C = 4,096) lies
above the fused capacity and takes the scan apply beside the fused
apply's groups; then a backlog staged as the JAX sequencer's paged
applier stages it, skipping the ring's flagged documents
(apply_ops_paged per group, serve_paged_burst for the
hot documents' 700 ops each at C = 8,192), a rollback_pages round trip
and compact_pages; every output held to the plain composition, the scan
launches per kernel held to the rule, the window's kernels counted as in
phase 8, the ring and the burst timed.
Phase 13 replays the 100,000-op keystroke trace op by op through the
port's MergeTreeClient (a prefix, within SCALAR_BUDGET_S), holds its
text to the device catch-up's, and fits the cost model
(mergetree/costmodel.py): scalar cost per op against live segments,
device wall per chunk and per op, and the crossover.
Phase 14 is the summarize path (bench.py summarize): with the counts at
0, full_step from fresh state, then the north-star state's extraction
(extract_visible_batched) fetched in both wire forms; the 1%-dirty pass
(gather_rows_pow2, compact_extract_batched(stats=True), the narrow fetch,
assemble_snapshot of every dirty document, device_stats.fold_extract);
compact_extract_paged(_keep) over phase 12's hot documents; the
100,000-op catch-up again and its entries through the narrow catch-up
wire; the counts read (fused apply, summary length, scan apply must have
launched, and so must zamboni.cu in each of its three modes and
narrow_pack.cu, with no plain compaction, extraction or narrow pack on the
card's tensors). Every output is held to the same function on CPU copies
of its inputs (the paged form to compact_pages + extraction), the narrow
fetch to the wide one (the wire must drop NARROW_MIN_DROP of the bytes),
the blob to an exact round trip, then the card to the JAX extraction
golden; the full and dirty passes and the paged form are timed. Then
zamboni.cu in each mode and narrow_pack.cu (on the fused mode's packed
rows) are held bit-exact to their plain versions on CPU copies of their
inputs at four shapes (the north-star state, the lane store's first
bucket of 16,384 x 64, the paged view of (3), one document at C =
4,096), each a row timed against its bound.
Phase 15 drives the sequencer's lane stores (server/tpu_sequencer.py):
first testing/lanes.golden_run against the committed JAX golden, then a
partition of HOT_RING's size (10,000 merge channels over 8 windows,
1,000 SharedMaps, 64 hot channels seeded from 3,500 entries, a 700-op
backlog on every storm and hot channel, an annotate storm, a full and a
dirty extract_all) through a bucketed store with the LWW store and a
paged store on the card, held to the same stores on the CPU and to each
other, each launch checked against the scan rule, window applies and
extractions timed, and every scan path timed at the stores' largest
shapes; the LWW store must launch the lane scan and never run its plain
version on the card's tensors, and the merge stores must launch zamboni.cu
(compaction and the fused compaction + extraction) and narrow_pack.cu and
never run the plain compaction, extraction or narrow pack on the card's
tensors. Phases 16, 17, 22, 23 and 24 each print zamboni.cu's launches by
mode and narrow_pack.cu's.
Phase 16 drives the sequencer lambda (server/tpu_sequencer.
TpuSequencerLambda, testing/lambda_runs.py scenarios) on the card: the
serving-ingest fleet at its full width (4,096 documents x 32 ops a wave)
through handler_raw and the pipelined ring, bucketed and paged, timed
(ops/s, flush p50, dispatches and kernel launches per window, the
device's busy share) and held to the JAX golden and to the port's CPU
twin in a child process; the ragged storm fleet, whose megakernel stream
must be order-identical to the per-window stream at fewer than 0.25
dispatches per window; and the mixed-family stream of 1,024 documents
through handler and handler_raw with a restart from the checkpoint, its
summaries and catch-up artifacts held to the JAX golden (the LWW apply
timed per launch; its largest lane-store launch held bit-exact against
the plain version and timed against its bound). The lambda must launch
the window's kernels and never run the plain LWW scan on the card's
tensors.
Phase 17 drives the local server (server/local_server.TpuLocalServer over
the sequencer lambda, with the scriptorium, scribe, broadcaster and
copier, 2 ingest partitions and 2 broadcaster shards) through
testing/server_runs.py on the card, bucketed and paged: connect, submit,
pump, summaries acked by the scribe, a restart of the ingest tier,
refresh_catchup / get_catchup and write_materialized_snapshots; timed
(ops/s, pump p50 and p99, the wall split by lambda, the device's busy
share, the tail) and held to the JAX golden and to the port's CPU twin in
a child process, with no admission nack; each kernel it launched is held
against its plain version at the inputs of its largest launch.
Phase 18 drives the operator's surface on the card: (a) the conformance
tool (tools/gpu_conformance.py --heavy: the fused apply against the scan
apply, bit for bit, at the JAX tool's shapes), (b) the microbench
(tools/microbench.run_all), (c) the serving decay probe
(server/decay_probe.py) at its default size, held to the JAX golden and to
a CPU twin by one lane digest, and at the serving fleet's widths, timed;
(d) the op bridge's transport-free core (server/bridge.OpBridge) at the
north-star shape, two sessions of three chained batches, every reply
byte-equal to the direct step's and the golden step's reply to the JAX
outputs, each stage timed; (e) phase 17's bucketed scenario over the C++
message log with a ServiceMonitor and a FleetObservatory on it, scraped
over HTTP every 100 ms during the measured waves with one /profile
capture, held to phase 17's golden and to a CPU twin, every scrape 200
and its exposition conformant. Each part must launch its path's kernels.
Phase 19 drives the client stack (loader/container.Loader, its local
driver, the container and data-store runtimes, the DDSes) on the card:
(a) testing/client_runs.py at golden.CLIENT_CARD on TpuLocalServer, with
late joiners of four kinds (a tail holding the sequences' attach ops, a
lazy resolve from a summary, a read-only resolve adopting the read
tier's artifact, a reconnect after a missed gap), held to the JAX golden
and to a CPU twin in a child process; the scan apply must launch under
MergeTreeClient.apply_bulk for the first and the last kind, the server
must launch the ticket scan. (b) BASELINE config #2 through the loader: a
reader follows the first READER_LIVE_OPS ops of phase 11's trace live,
disconnects, and reconnects after the rest, on a LocalServer; the cost
model must route its gap to the card, the scan apply must launch, the
text must equal the catch-up golden, and the bulk apply must finish on
the card (no scalar replay); the reconnect's wall is split and printed
beside phase 11's and beside the same device_apply_tail timed again after
(b), with no CPU twin running.
Phase 20 drives the application layer and the offline document path on
the card: (a) the four recorded corpora (testing/corpus.replay_digest)
against tests/corpus/pins.json, the keystroke corpus through
MergeTreeClient.apply_bulk against its scalar replay (the scan apply
must launch), and the snapshot corpus's digests against
tests/snapshots/pinned.json; (b) testing/app_runs (a BaseHost over the
code loader and the framework's default data store on TpuLocalServer, a
client_api Document, fetch, the file driver, the replay tool) held to
the JAX golden and to a CPU twin, with scan-apply launches under the
file driver's reload and the replay tool; (c) BASELINE config #2 as a
document: phase 11's trace written by one writer into a string a
framework data object created after the attach summary, captured by
fetch_document, reopened through a BaseHost over the file driver on the
card by the cost model's route, replayed by ReplayTool.from_capture with
two snapshot points (deterministic, no mismatch, every straight load
launching), and its first 5,000 ops through MergeTreeReplayer; the texts
held to the catch-up golden; each step's wall, the file load's split and
the storage checks' lazy replay per deferred op printed; the phase within
PHASE20_BUDGET_S. Phase 15's CPU twins start right after the kernel build and run
beside phases 1-14; phase 16's start when phase 15's card run ends,
phase 17's when phase 16's card part ends (each beside the wait for the
twins before it); the twins of phase 19 (a) and phase 20 (b) start with
phase 18 and run beside it.
Phase 21 drives the server services on the card: (b) a cluster takeover
(testing/cluster_runs at golden.CLUSTER_CARD: TpuLocalServer cores on
three orderer nodes through the cluster driver; the owner dies and node B
restores each document from its checkpoint), held to the JAX golden and
to a CPU twin, with ticket-scan and scan-apply launches; (c) the
deployment: the broker and the historian (store mode) as
`fluidframework_tpu_torch.server.main` processes, the tpu-deli worker on
the card once as a process (tests/test_deployment.py's shape) and once
built in this process against a second broker process and fed
testing/deploy_runs at golden.DEPLOY_CARD, its persisted deltas held to
the JAX golden document by document (ops/s, the broker's send µs a
message and the flush p50 printed); (a) BASELINE config #2 over real
sockets, cut to the trace's first NETWORK_OPS: a reader on the
routerlicious driver follows 3,000 ops of phase 11's trace live through
Tinylicious, misses 27,000 and reconnects, its gap fetched over alfred's
/deltas and applied through apply_bulk on the scan kernel, its text held
to golden.trace_text (the string replay that the CPU tests hold to the
catch-up golden); the phase within PHASE21_BUDGET_S.
Phase 22 drives the capacity soak and the client-side tools on the card:
(a) the chaos-on capacity grade (testing/capacity_runs.grade at
CAPACITY_CARD: 256 documents x 32 ticks, 2 partitions, 2 shards, an
open-loop seeded workload on the virtual clock, partition crash-restarts
and reconnect avalanches drawn from a FaultPlan; the grader's probes and
the capacity point twice) over TpuLocalServer on the card, after phase
21 (card_grade), held to the JAX golden and to a CPU twin started before
the kernel build, with every ticket-scan and scan-apply launch counted by
path (recovery apart) beside the stream ms between CUDA events recorded
around it;
(b) the keystroke load test with reconnect churn (testing/load_test
LoadRunner) over TpuLocalServer, its texts held to the JAX golden; (c) two
HeadlessAgentRunners hosting the IntelligenceRunner, the insights held to
the JAX golden; (d) testing/historian_smoke.main on the card; (e) the C
op packer (native/src/oppack.cpp) bit-exact to pack_ops_plain over a lane
fleet's windows, both timed.
Phase 23 drives the multi-device path on the card, in the main process
after phase 22: (a) phase 4's north-star step as full_step over a dp mesh
of four entries (the card's own devices when it has four, else four
entries of cuda:0), every kernel launching once per shard and the
gathered outputs and state bit-exact to phase 4's, the sharded step's
p50 beside phase 4's and each shard's kernel device ms; (b)
testing/server_runs on TpuLocalServer(mesh=...) bucketed at SERVER_CARD
and paged at SERVER_SMALL, every digest equal to the JAX golden (and to
phase 17's at SERVER_CARD), testing/shardcheck.verify_store passing, the
ticket scan and the scan apply launching on every shard, ops/s beside
phase 17's and the page copies between shards; (c) the long document of
tests/test_fused_sp.py (2 x 48 ops at C = 4,096) and a rich schedule
through apply_ops_fused_shardmap over dp=1 x sp=8 and dp=2 x sp=4,
bit-exact to scan_apply.cu, with the boundary exchanges per op, and
gpu_conformance.check_fused_sp; the phase's wall printed against
PHASE23_BUDGET_S.
Phase 24 runs the port's static gates and its runtime lockset check: (a)
the port's fluidlint (python -m fluidframework_tpu_torch.analysis over
fluidframework_tpu_torch/, its baseline applied) and its layer check, in
a child process started beside the kernel build (host work): the wall,
the files, the findings, the suppressed and baselined counts and the
layer check's verdict, failing on any unbaselined finding, layer
violation or import cycle; (b) the async-summary overlap
(testing/lambda_runs.summary_overlap_run: SUMMARY_DOCS documents x
SUMMARY_WAVES waves, summaries assembling while the next wave flushes) on
TpuSequencerLambda(device="cuda"), its MergeLaneStore wrapped by
testing/lockcheck.instrument with static_guards, which must map the
summarize state to _guard_lock; assert_clean() holds, the texts equal
those of the same seed run unwrapped on the card and on the CPU (in the
gates' process), and the ticket scan and the scan apply launch in the
wrapped run (counts reset just before it); the phase's wall printed
against PHASE24_BUDGET_S.
Prints one {"kernels": [...]} line, and as its last line
{"ok": true, "device": {...}}. Any mismatch or exception exits nonzero
before that line. Exits nonzero when CUDA is not available.
"""

from __future__ import annotations

import atexit
import gc
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEVICE = "cuda"
DOCS, OPS, CAPACITY, ANNO, TICKET_K = 10_000, 100, 256, 1, 8
TRIALS = 5
RUN_K = 8          # mergetree/oppack.RUN_K (checked in main)
K_SLOTS, A_SLOTS = 3, 4   # the serving defaults: MAX_OVERLAP_CLIENTS, anno
RING_STAGES = ("gather", "ticket", "admit", "apply_extract",
               "apply_runs_extract", "lww", "pack", "scatter")
RING_SPEC = "FULL_RING"   # testing/serving.py fleet of the timed rings
VARIANT_BATCH = 2048      # documents of phase 6's first variant batch
# H100 SXM peaks: HBM bytes/s (data sheet), and the integer rate for the
# lane operations: 64 INT32 lanes per SM per clock (NVIDIA Hopper
# architecture white paper, SM table), 132 SMs, 1.98 GHz boost clock.
# Each row also gives its bound at PEAK_FP32_OPS_PER_S, the data sheet's
# 67 TFLOP/s (an FMA counted as two), four times the integer rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 64 * 132 * 1.98e9
PEAK_FP32_OPS_PER_S = 67e12
# Phase 9: capacities fuzzed on each path (the warp path takes C <= 512),
# (K, A) pairs, seeds and documents (a batch that leaves the last block of
# a multi-document warp launch partly empty). One seed: the second one's
# 22 s did not fit the script's time limit (PERF.md §4).
FUZZ_CAPACITIES = (1, 31, 32, 33, 63, 64, 100, 255, 256, 257, 512, 1000,
                   1024, 1100)
FUZZ_SLOTS = ((3, 1), (3, 4))
FUZZ_SEEDS = (0,)
FUZZ_DOCS, FUZZ_OPS = 1059, 40
PATHS = ("warp", "block")
# At each main-path shape the rule's path may be at most this much slower
# on the device than the other path (timing noise; the rule's table is
# calibrate_fused_apply.py's).
PATH_MARGIN = 0.10
# Single launches whose least time is a scan path's device time (the
# launch latency varies by tens of microseconds, which decides a 0.2 ms
# kernel's ranking when only a few are taken).
PATH_REPS = 10
# A kernel row's plain version is timed on the call that gives the output
# the kernel is held to, or on a second, warm call when that took less.
WARM_PLAIN_MS = 50.0
# Phase 10: the scan apply's fuzz grid (capacities x documents x annotate
# slots, both variants, K=3), ops per stream by capacity, and the largest
# state (int32 elements) a cell may hold: a larger cell is dropped and
# printed (the plain version's temporaries are several states).
SCAN_CAPACITIES = (1, 33, 256, 1100, 4096, 4141, 4200, 16384, 65536)
SCAN_BATCHES = (1, 8, 256)
SCAN_ANNO = (1, 4, 64)
SCAN_MAX_INTS = 2**31
# Cluster sizes forced in phases 10 and 11 where they hold the table.
SCAN_CLUSTER_SIZES = (2, 4, 8, 16)
SM_COUNT = 132
# Phase 11's second path: full_step above the fused capacity (documents,
# ops, capacity; K=3, A=1).
SCAN_STEP = (1024, 100, 8192)
# The plain composition of phase 11 replays this prefix of the trace.
PLAIN_PREFIX = 10_000
# Phase 12: the testing/serving.py fleet with hot documents, its pool in
# pages, and each hot document's backlog in ops (the other documents take
# one window's worth of their class's ops).
HOT_SPEC = "HOT_RING"
HOT_POOL_PAGES = 32_768
HOT_BACKLOG = 700
RING_SCAN_STAGES = RING_STAGES + ("apply_scan_plain", "apply_scan_runs")
# Phase 13: the scalar replay stops after the block that crosses this many
# seconds (a stated prefix of the trace); blocks of this many ops are the
# points of the scalar fit; the device catch-up is timed on these
# prefixes of the same trace (and on the whole trace) for the device fit.
SCALAR_BUDGET_S = 30.0
SCALAR_BLOCK = 2_500
DEVICE_PREFIXES = (64, 256, 512, 2_048, 8_192, 32_768)
CROSSOVER_SEGMENTS = (20, 100, 300, 1_000, 3_000)
# Phase 14: the dirty documents of the incremental pass (every 100th, as
# bench.py summarize times it), the narrow wire's least byte drop against
# the wide fetch (bench.py summarize-smoke's gate), and the documents whose
# snapshots are assembled on the full pass.
DIRTY_STRIDE = 100
NARROW_MIN_DROP = 0.40
# Phase 14's rows of zamboni.cu and narrow_pack.cu: the sources, the JAX
# functions each mode replaces, the kernels by name, and two of the four
# shapes (the lane store's first bucket, lanes x C, and the catch-up
# fold's one document's C; the others are the north-star state and phase
# 14 (3)'s paged view).
ZAMBONI_SOURCE = "fluidframework_tpu_torch/kernels/csrc/zamboni.cu"
NARROW_SOURCE = "fluidframework_tpu_torch/kernels/csrc/narrow_pack.cu"
ZAMBONI_REPLACES = {"compact": "fluidframework_tpu/mergetree/kernel.py:503",
                    "compact_extract":
                        "fluidframework_tpu/mergetree/kernel.py:710",
                    "extract": "fluidframework_tpu/mergetree/kernel.py:697",
                    "narrow_pack":
                        "fluidframework_tpu/mergetree/kernel.py:817"}
ZAMBONI_KERNELS = ("zamboni_kernel<0>", "zamboni_kernel<1>",
                   "zamboni_kernel<2>", "narrow_pack_kernel")
LANE_BUCKET0 = (16_384, 64)
FOLD_C = 4_096
# Phase 15: the sequencer's lane stores over a partition (testing/
# serving.py HOT_RING: FULL_RING's 10,000 documents + 64 hot ones) from
# testing/lanes.scenario: the seed, the backlog on each storm and hot
# channel, the dirty pass's stride; the store shapes whose every scan path is timed.
LANE_SPEC = "HOT_RING"
LANE_SEED = 15
LANE_BACKLOG = 700
LANE_DIRTY_STRIDE = 100
LANE_ROW_SHAPES = 4
# The CPU composition of phase 15 runs in a process per store, started
# after the kernel build (CPU threads each may use; seconds each may take
# once phase 15 reads it).
LANE_CPU_THREADS = 3
LANE_CPU_TIMEOUT = 600
# Phase 16, the sequencer lambda: the serving-ingest fleet's measured
# waves (after testing/ingest.warm_waves; traced by the profiler for the
# device's busy share), the extra wave after them, and the CPU twins.
LAMBDA_MEASURED, LAMBDA_EXTRA = 3, 1
# Phase 17: the CPU twin's threads and time limit per layout.
SERVER_CPU_THREADS = 2
SERVER_CPU_TIMEOUT = 900
LAMBDA_CPU_THREADS = 3
LAMBDA_CPU_TIMEOUT = 900
# An L2 flush: a buffer larger than the H100's 50 MB L2, written before
# each cold-timed launch.
L2_FLUSH_INTS = 64 << 20
# Phase 2: summary-length shapes (B, C): the north-star's, a batch of one
# block less one document, C past and short of whole 16-byte vectors and
# of whole warps, and the block path's 1,100.
SUMMARY_SHAPES = ((10_000, 256), (9_999, 256), (37, 64), (8, 1024),
                  (37, 1), (37, 3), (37, 33), (37, 1100))
# Phase 2b: the ticket scan's grid. Client slots (K = 40 takes two table
# registers a lane), message steps (T = 0 launches nothing; 32 is one load
# chunk), documents (the plain version runs once at the largest B;
# documents are independent, so its first rows are the smaller batches'
# reference), and the contracts (kind column, require_join).
TICKET_SLOTS = (1, 3, 8, 32, 40)
TICKET_STEPS = (0, 1, 31, 32, 33, 100)
TICKET_BATCHES = (1, 7, 10_000)
TICKET_MODES = ((False, False), (False, True), (True, False), (True, True))
# The ticket scan's operations for its bound, counted on this run's
# messages, a table slot at a time where the function needs the table:
# a LEAVE's match compare and evicting select (2 a slot); an OP's or a
# JOIN's match and free compares (2 a slot; the first-true picks and the
# any are votes on them); a ticketed OP's or JOIN's update of its slot
# (1 a slot); every ticketed message's MSN, the active test, the masked
# select and the min (3 a slot); the emptiness test where the table
# changed, the OR of those active tests (1 a slot); and 30 operations on
# every message's own scalars (the kind tests, the dup / stale / nack
# decisions, the seq and the MSN's clamp).
TICKET_OPS_LEAVE_SLOT = 2
TICKET_OPS_VOTE_SLOT = 2
TICKET_OPS_UPDATE_SLOT = 1
TICKET_OPS_MSN_SLOT = 3
TICKET_OPS_EMPTY_SLOT = 1
TICKET_OPS_PER_MESSAGE = 30
# fused_apply.cu's ptxas registers as PERF.md §6 records them: the block
# path 64 in every variant; the warp path by (kR, runs).
FUSED_WARP_REGISTERS = {(1, 0): 73, (1, 1): 76, (2, 0): 71, (2, 1): 77,
                        (4, 0): 73, (4, 1): 79, (8, 0): 97, (8, 1): 110,
                        (16, 0): 126, (16, 1): 127}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi unavailable ({exc})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


# The garbage collector's thresholds in this script's process and its CPU
# twins (CPython's default is (700, 10, 10)): the phases build large live
# heaps of servers, clients and logs, over which the default thresholds ran
# a full collection every second or so (PERF.md §5: 79 in phase 22 alone,
# 91.6 s of full collections in all).
GC_THRESHOLDS = (50_000, 20, 20)
# A twin process's command: the script's collector thresholds, then its
# entry point.
TWIN_PRELUDE = "import sys, chip_smoke; chip_smoke.harness_gc(); "


def harness_gc() -> None:
    """Set GC_THRESHOLDS in this process."""
    gc.set_threshold(*GC_THRESHOLDS)


class PhaseClock:
    """Each part's wall and the garbage collector's pauses in it. At every
    mark() the part that ends is printed, the cyclic garbage it left is
    collected, and every object still alive is frozen (gc.freeze), so that
    a later full collection walks only what the later parts make, not the
    heap that the earlier ones keep (such a pass took 5.0 s in phase 19
    (b)'s reconnect and 6.6 s in phase 20 (c)'s file load with nothing
    frozen)."""

    def __init__(self, t_start: float, label: str):
        self.t_start, self.label = t_start, label
        self.t_part = time.perf_counter()
        self.pauses = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
        self._t0 = None
        self._own = False
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if self._own:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            p = self.pauses[info["generation"]]
            p[0] += 1
            p[1] += time.perf_counter() - self._t0
            self._t0 = None

    def mark(self, label: str) -> None:
        now = time.perf_counter()
        full, young = self.pauses[2], (
            self.pauses[0][0] + self.pauses[1][0],
            self.pauses[0][1] + self.pauses[1][1])
        self._own = True
        try:
            gc.collect()
            collect_s = time.perf_counter() - now
            gc.freeze()
        finally:
            self._own = False
        print(f"chip_smoke: {self.label} took {now - self.t_part:.1f} s, "
              f"ending {now - self.t_start:.1f} s into the run; the garbage "
              f"collector's pauses in it: {full[0]} full for {full[1]:.2f} "
              f"s, {young[0]} young for {young[1]:.2f} s; the collection at "
              f"its end {collect_s:.2f} s, then {gc.get_freeze_count()} "
              f"objects frozen", flush=True)
        self.pauses = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
        self.label = label
        self.t_part = time.perf_counter()

    def close(self) -> None:
        gc.callbacks.remove(self._on_gc)


def ms_of(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int) -> dict:
    """Device milliseconds per call of each CUDA kernel fn launches, from
    torch.profiler's CUPTI trace over `reps` calls (after one warm-up):
    {kernel name: (ms per call, launches per call)}. Unlike ms_of, the
    host's pace between launches is not counted."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0:
            out[ev.key] = (us / 1e3 / reps, ev.count / reps)
    return out


def one_kernel_ms(fn, reps: int, kernel: str):
    """Device milliseconds per launch of the kernels whose name contains
    `kernel` (fn launches one), from kernel_device_ms; a trace that holds
    no such kernel is taken once more, then None (not measured)."""
    for _ in range(2):
        trace = kernel_device_ms(fn, reps)
        got = [(ms, n) for name, (ms, n) in trace.items() if kernel in name]
        if got:
            return sum(ms for ms, _n in got) / sum(n for _ms, n in got)
    print(f"  profiler: no {kernel} in the trace; it holds "
          f"{sorted(trace)[:6]}", flush=True)
    return None


def path_times(state, ops, runs, extract: bool, reps: int) -> dict:
    """{path: {"device_ms", "ms"}} of one fused-apply launch on each path,
    forced whatever the rule says: the path's kernel device time
    (torch.profiler) and the mean of back-to-back calls (CUDA events)."""
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    out = {}
    for p in PATHS:
        geo = pa._forced_geometry(p, state.capacity, state.overlap_slots,
                                  state.anno_slots)

        def run():
            return pa._launch(state, ops, runs, extract, geo)
        out[p] = {"device_ms": one_kernel_ms(run, reps,
                                             f"fused_apply_kernel_{p}"),
                  "ms": ms_of(run, reps)}
    return out


def check_paths(what: str, row: dict, card: str) -> None:
    """Print both paths' times at a main-path shape, and fail unless the
    rule's path is measured and at most PATH_MARGIN slower on the device
    than the other."""
    times = "; ".join(f"{p} {fmt_ms(t['device_ms'])} device, "
                      f"{t['ms']:.4f} ms back to back"
                      for p, t in row["paths"].items())
    print(f"  fused_apply paths at {what}: {times}; the rule takes "
          f"{row['path']}; card {card}", flush=True)
    dev_ms = {p: t["device_ms"] for p, t in row["paths"].items()}
    require(None not in dev_ms.values(),
            f"fused_apply paths at {what}: device time not measured")
    other = min(ms for p, ms in dev_ms.items() if p != row["path"])
    require(dev_ms[row["path"]] <= other * (1 + PATH_MARGIN),
            f"fused_apply at {what}: the rule's {row['path']} path "
            f"({dev_ms[row['path']]:.4f} ms) is more than {PATH_MARGIN:.0%} "
            f"slower than the other ({other:.4f} ms)")


def fused_registers_recorded(key: str):
    """The recorded register count of a fused-apply kernel named as
    ptxas_report names it."""
    args = [int(x) for x in re.findall(r"\d+", key.split("<", 1)[-1])]
    if key.startswith("fused_apply_kernel_block"):
        return 64
    return FUSED_WARP_REGISTERS.get((args[0], args[1])) if args else None


def once_ms(fn) -> float:
    """Device milliseconds of one call of fn (CUDA events, no warm-up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def plain_once(fn) -> tuple:
    """(ms, output) of a plain version: once_ms around the call whose
    output the kernel is held to; a call under WARM_PLAIN_MS is timed
    once more, warm, since a first call's set-up would be much of it."""
    out = []
    ms = once_ms(lambda: out.append(fn()))
    if ms < WARM_PLAIN_MS:
        ms = once_ms(fn)
    return ms, out[0]


def cold_ms(fn, reps: int) -> float:
    """Median device milliseconds of one call of fn with the L2 cold: a
    buffer of L2_FLUSH_INTS int32 (256 MB, five times the H100's 50 MB
    L2) is written before each timed launch (CUDA events around the
    launch alone)."""
    flush = torch.empty(L2_FLUSH_INTS, dtype=torch.int32,
                        device=torch.device(DEVICE))
    fn()
    times = []
    for i in range(reps):
        flush.fill_(i)
        times.append(once_ms(fn))
    del flush
    return float(np.median(times))


def cold_device_ms(fn, reps: int, kernel: str):
    """Device milliseconds per launch of the kernels whose name holds
    `kernel` (fn launches one) with the L2 cold: torch.profiler's trace
    of `reps` calls, each after a write of the L2_FLUSH_INTS buffer. The
    kernel's own time: no host launch latency, unlike cold_ms. None when
    the trace holds no such kernel (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_INTS, dtype=torch.int32,
                        device=torch.device(DEVICE))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            flush.fill_(i)
            fn()
        torch.cuda.synchronize()
    del flush
    got = [(ev.self_device_time_total, ev.count)
           for ev in prof.key_averages()
           if kernel in ev.key and ev.self_device_time_total > 0]
    if not got:
        return None
    return sum(us for us, _n in got) / 1e3 / sum(n for _us, n in got)


def ticket_scan_bytes(b: int, t: int, k: int, with_kind: bool) -> int:
    """Bytes the ticket scan must move: the [B, T] int32 message columns
    read once (client, client_seq, ref_seq, and kind where given), the
    [B, T] outputs written once (seq and msn int32, three bools), and the
    state read and written once ([B, K] int32 x 3, [B] int32 x 2, [B]
    bool)."""
    per_message = (4 if with_kind else 3) * 4 + 2 * 4 + 3
    state = 3 * k * 4 + 2 * 4 + 1
    return b * t * per_message + 2 * b * state


def ticket_scan_ops(ops, ticketed, overflow, k: int) -> int:
    """Operations the ticket scan needs on this run's messages (ops, a
    RawOps) given what the plain version made of them (ticketed, and the
    [B] overflow flags after the window), by the TICKET_OPS_* counts. A
    message was ticketed where its seq is not 0 (the first seq is 1). A
    ticketed JOIN in a document that overflowed may have found the table
    full and changed nothing: it is counted without the update and the
    emptiness test, an under-count only there."""
    from fluidframework_tpu_torch.server.ticket_kernel import MsgKind
    has_client = ops.client >= 0
    if ops.kind is None:
        op, join, leave = has_client, torch.zeros_like(has_client), \
            torch.zeros_like(has_client)
    else:
        op = has_client & (ops.kind == MsgKind.OP)
        join = has_client & (ops.kind == MsgKind.JOIN)
        leave = has_client & (ops.kind == MsgKind.LEAVE)
    ticket = ticketed.seq != 0
    updated = ticket & (op | (join & ~overflow[:, None]))
    changed = updated | (ticket & leave)
    per_slot = (TICKET_OPS_LEAVE_SLOT * int(leave.sum())
                + TICKET_OPS_VOTE_SLOT * int((op | join).sum())
                + TICKET_OPS_UPDATE_SLOT * int(updated.sum())
                + TICKET_OPS_MSN_SLOT * int(ticket.sum())
                + TICKET_OPS_EMPTY_SLOT * int(changed.sum()))
    return k * per_slot + TICKET_OPS_PER_MESSAGE * ops.client.numel()


def rows_of(tup, n: int):
    """The first n documents of a NamedTuple of [B, ...] tensors."""
    return type(tup)(*(None if x is None else x[:n] for x in tup))


def misaligned(state):
    """state with its length, ins_seq and rem_seq planes copied into
    contiguous views that start one int32 past an allocation (not 16-byte
    aligned: the summary kernel's scalar loop)."""
    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out
    return state._replace(length=shifted(state.length),
                          ins_seq=shifted(state.ins_seq),
                          rem_seq=shifted(state.rem_seq))


def long_kernel_ms(fn, reps: int):
    """(device ms per launch, how) of a function that launches one long
    kernel: the least of `reps` single launches between two CUDA events,
    after one warm-up (for a kernel of a tenth of a millisecond or more
    the events add a few microseconds). torch.profiler's traces of the
    scan kernel came back empty, or held part of its time (3.0963 ms for
    a 6.3 ms launch), on the H100, so every path is timed the same
    way."""
    fn()
    return min(once_ms(fn) for _ in range(reps)), "events"


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} from the
    nvcc -Xptxas -v log, kernels named readably (fused_apply_kernel_warp
    <kR,runs,extract>, fused_apply_kernel_block<runs,extract>)."""
    out, entry, cur = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]),
                spill_loads=int(m[3]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m[1])
    pretty = {}
    for name, rep in out.items():
        if "registers" not in rep:  # a device function, not a kernel
            continue
        args = re.findall(r"L[ib](\d+)E", name)
        key = kernel_ident(name) + (f"<{','.join(args)}>" if args else "")
        pretty[key] = rep
    return pretty


def kernel_ident(mangled: str) -> str:
    """The first length-prefixed identifier of a mangled name that holds
    "kernel" (summary_len_kernel out of _ZN..18summary_len_kernel..),
    else the name as it is."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        ident = mangled[start:start + int(m.group())]
        if "kernel" in ident:
            return ident
        i = start + len(ident)
    return mangled


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two tuples of integer/bool tensors."""
    err = 0
    for x, y in zip(a, b):
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max().item()) if d.numel() else 0)
    return err


def assert_tuple_equal(got, want, what: str) -> None:
    for name, g, w in zip(got._fields, got, want):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{what}: {name} dtype/shape {g.dtype}{tuple(g.shape)} vs "
                f"{w.dtype}{tuple(w.shape)}")
        if not bool((g == w).all()):
            bad = int((g != w).sum())
            raise SmokeFailure(f"{what}: field {name} differs in {bad} "
                               "elements")


def assert_matches_numpy(got, want: dict, what: str) -> None:
    for name, g in zip(got._fields, got):
        if g is None:
            continue
        arr = g.cpu().numpy()
        require(arr.dtype == want[name].dtype,
                f"{what}: {name} dtype {arr.dtype} vs {want[name].dtype}")
        if not np.array_equal(arr, want[name]):
            raise SmokeFailure(f"{what}: field {name} differs from the JAX "
                               "golden output")


def random_tables(seed: int, batch: int, capacity: int, device):
    """Arbitrary segment tables for the summary-length comparisons."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree.constants import (
        DEV_NO_REMOVE, DEV_UNASSIGNED)
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 200, (batch, capacity)).astype(np.int32)
    pick = rng.integers(0, 4, (batch, capacity))
    st = {
        "length": rng.integers(0, 9, (batch, capacity)).astype(np.int32),
        "ins_seq": np.where(pick == 0, DEV_UNASSIGNED, seqs).astype(np.int32),
        "rem_seq": np.where(pick == 1, seqs + 5,
                            np.where(pick == 2, DEV_UNASSIGNED,
                                     DEV_NO_REMOVE)).astype(np.int32),
        "count": rng.integers(0, capacity + 1, batch).astype(np.int32),
        "seq": rng.integers(0, 220, batch).astype(np.int32),
    }
    k, a = 3, 1
    st.update(
        ins_client=np.zeros((batch, capacity), np.int32),
        local_seq=np.zeros((batch, capacity), np.int32),
        rem_local_seq=np.zeros((batch, capacity), np.int32),
        rem_clients=np.full((batch, capacity, k), -1, np.int32),
        origin_op=np.zeros((batch, capacity), np.int32),
        origin_off=np.zeros((batch, capacity), np.int32),
        anno=np.full((batch, capacity, a), -1, np.int32),
        min_seq=np.zeros(batch, np.int32),
        overflow=np.zeros(batch, bool))
    return interop.doc_state_from_numpy(st, device)


def fused_apply_lane_ops(kinds: np.ndarray, slots, k: int, a: int) -> float:
    """Integer lane operations the fused apply's formulation needs for the
    [B, T] op kinds when op (b, t) touches slots[b, t] slots of its
    document (a scalar: the same for every op): per slot, visibility +
    scan (8 + K), boundary test (4), shift of all planes (2 per plane),
    insert stop test (8) and fill (P), remove (10 + 3K), annotate (4 + A),
    ack (6), and for an INSERT_RUN a boundary test, a visibility pass, the
    stop test, a shift of every plane, the RUN_K-term member selects of
    length/seq/op_id (2 per term), the live/dead masks (4) and the fill
    (P). Counted from the kinds actually in the stream."""
    planes = 8 + k + a
    vis = 8 + k
    boundary = vis + 4 + 2 * planes
    per_slot = np.zeros(7, np.int64)
    per_slot[1] = boundary + vis + 8 + 2 * planes + planes      # insert
    per_slot[2] = 2 * boundary + vis + 10 + 3 * k               # remove
    per_slot[3] = 2 * boundary + vis + 4 + a                    # annotate
    per_slot[4] = per_slot[5] = 6                               # acks
    per_slot[6] = boundary + vis + 8 + 2 * planes + 3 * 2 * RUN_K + 4 \
        + planes                                                # runs
    return float((per_slot[kinds] * np.broadcast_to(
        np.asarray(slots, np.int64), kinds.shape)).sum())


def live_slots(state, ops, runs=None) -> np.ndarray:
    """[B, T]: the slots op t of document b has to touch, from the plain
    version's count before it: the rows in use and those the op may add
    (count + 2, count + RUN_K + 1 for a run, at most C) when the padding
    past count holds one value per plane, which no op moves or changes
    but an ack (an ack that reaches the padding is counted at these rows
    too); else all C slots. The work of the function on this run's data,
    where fused_apply_lane_ops(kinds, C, ...) counts every slot."""
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree.oppack import OpKind
    k, a = state.overlap_slots, state.anno_slots
    c = state.capacity
    st = pa._to_planes(state)
    fields, cols = pa.op_cols(ops, runs)
    lane = torch.arange(c, device=state.length.device)
    out = []
    for t in range(ops.steps):
        count = st["count"]
        pad = lane >= count
        at = count.clamp(0, c - 1).long()
        uniform = (count >= 0) & (count <= c)
        for name in pa._plane_names(k, a):
            first = st[name].gather(1, at)
            uniform &= ((st[name] == first) | ~pad).all(1, keepdim=True)
        op = {f: cols[f][:, t:t + 1] for f in fields}
        need = 2 if runs is None else torch.where(
            op["kind"] == OpKind.INSERT_RUN, RUN_K + 1, 2)
        out.append(torch.where(uniform, (count + need).clamp(max=c), c))
        st = pa._apply_one_batched(st, op, k, a, pa.local_lanes(c),
                                   with_runs=runs is not None)
    return torch.cat(out, 1).cpu().numpy()


def fused_apply_bytes(batch: int, capacity: int, steps: int, k: int, a: int,
                      runs: bool, extract: bool) -> float:
    """Bytes the fused apply must move: the state read once and written
    once ((8 + K + A) int32 planes + three int32 scalars + the overflow
    byte per document), the 10 op columns, the 3 RunCols columns with
    runs=, and the 14 narrow bytes per document with extract=True."""
    state = (8 + k + a) * capacity * 4 + 13
    per_doc = 2 * state + 10 * steps * 4 + \
        (3 * steps * RUN_K * 4 if runs else 0) + (14 if extract else 0)
    return float(batch * per_doc)


def assert_trees_equal(got, want, what: str) -> None:
    """Two output trees of the same structure (NamedTuples, tuples,
    tensors): every leaf equal in dtype, shape and value."""
    if want is None:
        require(got is None, f"{what}: expected None")
    elif hasattr(want, "_fields"):
        for name, g, w in zip(want._fields, got, want):
            assert_trees_equal(g, w, f"{what}.{name}")
    elif isinstance(want, (tuple, list)):
        require(len(got) == len(want), f"{what}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{what}[{i}]")
    else:
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"{what}: dtype/shape {got.dtype}{tuple(got.shape)} vs "
                f"{want.dtype}{tuple(want.shape)}")
        if not bool((got == want).all()):
            raise SmokeFailure(f"{what}: differs in "
                               f"{int((got != want).sum())} elements")


def long_table(dev, batch: int, capacity: int, rows: int):
    """`rows` one-char segments at seq 0 per document (phase 6: so that
    every shift moves lanes across the 1,024-thread chunk boundary), K=3,
    A=4, built on `dev`."""
    from fluidframework_tpu_torch.mergetree.state import make_state
    st = make_state(capacity, A_SLOTS, K_SLOTS, batch=batch, device=dev)
    st.length[:, :rows] = 1
    st.ins_seq[:, :rows] = 0
    st.ins_client[:, :rows] = 0
    st.origin_op[:, :rows] = torch.arange(rows, dtype=torch.int32,
                                          device=st.length.device)
    st.count[:] = rows
    return st


def ring_trial(serve, ts, pool_pre, lww, args, stage_names=None):
    """One timed megakernel ring from a copy of the pre-ring pool: (device
    ms, host ms, {stage: device ms} when stage_names is given)."""
    pool = type(pool_pre)(*(t.clone() for t in pool_pre))
    torch.cuda.synchronize()
    marks = []

    def stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    e0.record()
    serve(ts, pool, lww, *args, stats=True,
          stage=stage if stage_names is not None else None)
    e1.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - h0) * 1e3
    split = None
    if stage_names is not None:
        split = dict.fromkeys(stage_names, 0.0)
        prev = e0
        for name, ev in marks:
            split[name] += prev.elapsed_time(ev)
            prev = ev
    return e0.elapsed_time(e1), host, split


def main(north_star_only: bool = False) -> int:
    """Every phase; north_star_only=True (--north-star) stops after phase
    5 and prints that part's kernel rows, for a quick check of a kernel
    change."""
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from fluidframework_tpu_torch import interop, kernels
    from fluidframework_tpu_torch.kernels import build
    from fluidframework_tpu_torch.mergetree import pallas_apply, pallas_ops
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import gen_traces

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name}", flush=True)
    harness_gc()
    capacity_twin = None if north_star_only else start_capacity_twin()
    scalar_twin = None if north_star_only else start_scalar_twin()
    gates_twin = None if north_star_only else start_gates_twin()
    clock = PhaseClock(t_start, "the kernel build and the set-up")
    set_up_pool = ThreadPoolExecutor(max_workers=2)
    set_up = None if north_star_only else start_set_up(set_up_pool)

    # -- phase 1: build + selftest ---------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"setup: kernel build {time.perf_counter() - t0:.2f} s "
          f"({build.source_hash()})", flush=True)
    # Phase 15's CPU twins run beside phases 1-14 (the paged store's is
    # the longest twin of the script).
    lane_twins = None if north_star_only else start_lane_twins()
    twins_from = time.perf_counter()
    if set_up is not None:
        t0 = time.perf_counter()
        early = finish_set_up(set_up)
        del set_up
        print(f"setup: phase 10's {len(early['scan'])} largest tables and "
              f"phase 18 (c)'s {len(early['decay'])} fleet waves were drawn "
              f"beside the build; waited {time.perf_counter() - t0:.2f} s "
              f"after it", flush=True)
    set_up_pool.shutdown()
    clock.mark("phases 1-5")
    ptxas = build.BUILD_ROOT / build.source_hash() / "ptxas.log"
    require(ptxas.exists(), f"no ptxas report beside the library ({ptxas})")
    report = ptxas_report(ptxas.read_text())
    for kern, r in sorted(report.items()):
        print(f"  ptxas: {kern}: {r.get('registers')} registers, "
              f"{r.get('stack')} bytes stack, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spill stores / loads")
    apply_kernels = {k: r for k, r in report.items() if "fused_apply" in k}
    require(len(apply_kernels) == 24,
            f"expected 24 fused apply kernels, ptxas reports "
            f"{sorted(apply_kernels)}")
    scan_kernels = {k: r for k, r in report.items() if "scan_apply" in k}
    require(len(scan_kernels) == 8,
            f"expected 8 scan apply kernels (4 paths x 2 variants), ptxas "
            f"reports {sorted(scan_kernels)}")
    mine = sorted(k for k in report if "ticket_scan" in k
                  or "summary_len" in k)
    require(mine == ["summary_len_kernel",
                     "ticket_scan_kernel<1>", "ticket_scan_kernel<2>",
                     "ticket_scan_kernel<3>", "ticket_scan_kernel<4>"],
            f"expected the summary-length kernel and 4 ticket-scan "
            f"kernels, ptxas reports {mine}")
    window = sorted(k for k in report if k in WINDOW_KERNELS)
    require(window == sorted(WINDOW_KERNELS), f"expected the serving "
            f"window's kernels {sorted(WINDOW_KERNELS)}, ptxas reports "
            f"{window}")
    zamboni = sorted(k for k in report if k in ZAMBONI_KERNELS)
    require(zamboni == sorted(ZAMBONI_KERNELS), f"expected the zamboni "
            f"and narrow-pack kernels {sorted(ZAMBONI_KERNELS)}, ptxas "
            f"reports {zamboni}")
    checked = {*apply_kernels, *scan_kernels, *mine, *window, *zamboni}
    spilled = sorted(k for k in checked  # refused after the timings
                     if any(report[k].get(key) for key in
                            ("stack", "spill_stores", "spill_loads")))
    moved = {k: (r.get("registers"), fused_registers_recorded(k))
             for k, r in apply_kernels.items()
             if r.get("registers") != fused_registers_recorded(k)}
    print("  ptxas: fused_apply registers "
          + ("equal to the table recorded in PERF.md" if not moved else
             f"differ from the table recorded in PERF.md (now, then): "
             f"{moved}"), flush=True)
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    st_out = kernels.selftest(x)
    torch.cuda.synchronize()
    require(bool((st_out == kernels.selftest_plain(x)).all()),
            "selftest differs from 2 * x")
    print("phase 1: selftest bit-exact", flush=True)

    # -- phase 2: summary length kernel vs plain -------------------------
    for seed, (b, c) in enumerate(SUMMARY_SHAPES):
        st = random_tables(seed, b, c, dev)
        want = pallas_ops.summary_lengths_plain(st)
        for what, st_in in (("aligned", st), ("misaligned", misaligned(st))):
            got = pallas_ops.summary_lengths(st_in)
            torch.cuda.synchronize()
            require(bool((got == want).all()),
                    f"summary_lengths differs at B={b} C={c} ({what} "
                    "rows)")
        print(f"phase 2: summary_lengths bit-exact at B={b} C={c}, "
              f"aligned and misaligned rows", flush=True)

    # -- phase 2b: ticket scan kernel vs plain ---------------------------
    ticket_phase(dev)

    # -- phase 3: fused apply kernel vs plain vs JAX golden --------------
    def check_apply(state, ops, what):
        got = pallas_apply.apply_ops_fused(state, ops)
        want = pallas_apply.apply_ops_fused_plain(state, ops)
        torch.cuda.synchronize()
        assert_tuple_equal(got, want, what)
        return got

    cols = gen_traces(2048, 100, seed=1)
    check_apply(make_state(CAPACITY, ANNO, batch=2048, device=dev),
                interop.packed_ops_from_numpy(cols, dev),
                "apply gen_traces(2048, 100) C=256")
    print("phase 3: apply bit-exact on gen_traces(2048, 100) C=256",
          flush=True)
    cols = gen_traces(6, 120, seed=2)
    check_apply(make_state(1100, 2, batch=6, device=dev),
                interop.packed_ops_from_numpy(cols, dev),
                "apply gen_traces(6, 120) C=1100")
    print("phase 3: apply bit-exact at C=1100 (two thread chunks)",
          flush=True)
    g = golden.load()
    got = check_apply(interop.doc_state_from_numpy(g["apply_in"], dev),
                      interop.packed_ops_from_numpy(g["apply_op"], dev),
                      "apply golden")
    assert_matches_numpy(got, g["apply_out"], "apply golden vs JAX")
    tout, mout, ticketed, total = pipeline.full_step(
        interop.ticket_state_from_numpy(g["step_tin"], dev),
        interop.doc_state_from_numpy(g["step_min"], dev),
        interop.raw_ops_from_numpy(g["step_raw"], dev),
        interop.packed_ops_from_numpy(g["step_op"], dev))
    assert_matches_numpy(tout, g["step_tout"], "full_step golden tstate")
    assert_matches_numpy(mout, g["step_mout"], "full_step golden mstate")
    assert_matches_numpy(ticketed, g["step_ticketed"],
                         "full_step golden ticketed")
    require(np.array_equal(total.cpu().numpy(),
                           g["step_total"]["total_len"]),
            "full_step golden total_len")
    print("phase 3: apply and full_step equal the JAX golden outputs",
          flush=True)

    # -- phase 4: the north-star step through the kernels ----------------
    cols = gen_traces(DOCS, OPS, seed=0)
    ops = interop.packed_ops_from_numpy(cols, dev)
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)

    def fresh():
        return (tk.make_ticket_state(TICKET_K, DOCS, device=dev),
                make_state(CAPACITY, ANNO, batch=DOCS, device=dev))

    wrappers = {"selftest": kernels.selftest,
                "ticket_scan": tk.scan_tickets,
                "summary_len": pallas_ops.summary_lengths,
                "fused_apply": pallas_apply.apply_ops_fused}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        pallas_apply.reset_launches()

    def read_counts():
        got = {k: fn.launches for k, fn in wrappers.items()}
        got.update({f"fused_apply[{v}]": n for v, n in
                    pallas_apply.apply_ops_fused.variant_launches.items()})
        got.update({f"fused_apply<{p}>": n for p, n in
                    pallas_apply.apply_ops_fused.path_launches.items()})
        return got

    reset_counts()
    tout, mout, ticketed, total = pipeline.full_step(*fresh(), raw, ops)
    torch.cuda.synchronize()
    launches = read_counts()
    require(launches["ticket_scan"] == 1 and launches["fused_apply"] > 0
            and launches["summary_len"] > 0,
            f"main path did not launch every kernel: {launches}")
    geo = pallas_apply.launch_geometry(DOCS, CAPACITY, 3, ANNO)
    require(launches[f"fused_apply<{geo.path}>"] == launches["fused_apply"],
            f"the north-star apply did not take the {geo.path} path that "
            f"launch_geometry names: {launches}")
    require(not bool(mout.overflow.any()), "north-star step overflowed")
    require(total.shape == (DOCS,) and total.dtype == torch.int32
            and bool((total >= 0).all()), "total_len shape/dtype/range")
    p_tout, p_mout, p_ticketed, p_total = pipeline.make_full_step(
        plain=True)(*fresh(), raw, ops)
    torch.cuda.synchronize()
    assert_tuple_equal(mout, p_mout, "north-star mstate vs plain")
    assert_tuple_equal(tout, p_tout, "north-star tstate vs plain")
    assert_tuple_equal(ticketed, p_ticketed, "north-star ticketed vs plain")
    require(bool((total == p_total).all()), "north-star total_len vs plain")
    print(f"phase 4: full_step {DOCS}x{OPS} C={CAPACITY} through the "
          f"kernels ({geo}), launches {launches}, equal to the plain "
          "composition", flush=True)

    # warm timing: one warm-up, then p50 of TRIALS from fresh state
    pipeline.full_step(*fresh(), raw, ops)
    torch.cuda.synchronize()
    step_ms, host_ms = [], []
    for _ in range(TRIALS):
        ts, ms = fresh()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        pipeline.full_step(ts, ms, raw, ops)
        e1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(e0.elapsed_time(e1))
    stage = {"ticket": [], "apply": [], "summary": []}
    for _ in range(TRIALS):
        ts, ms = fresh()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        ts, tkd = tk.scan_tickets(ts, raw)
        ev[1].record()
        ms = pallas_apply.apply_ops_fused(ms, pipeline.admit_ops(ops, tkd))
        ev[2].record()
        pallas_ops.summary_lengths(ms)
        ev[3].record()
        torch.cuda.synchronize()
        for i, key in enumerate(stage):
            stage[key].append(ev[i].elapsed_time(ev[i + 1]))
    p50 = float(np.median(step_ms))
    split = {k: round(float(np.median(v)), 3) for k, v in stage.items()}
    print(f"full_step: {DOCS * OPS / (p50 / 1e3):.0f} ops/s, p50 {p50:.3f} "
          f"ms (host clock p50 {float(np.median(host_ms)):.3f} ms, trials "
          f"{[round(v, 3) for v in step_ms]}), stage p50 ms {split}; "
          f"card {card}", flush=True)

    # -- phase 5: per-kernel numbers at the north-star path's shapes -------
    tstate0, mstate0 = fresh()
    admitted = pipeline.admit_ops(ops, ticketed)
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    summary_bytes = DOCS * (3 * CAPACITY * 4 + 3 * 4)

    def scan_kernel():
        return tk.scan_tickets(tstate0, raw)

    def scan_plain():
        return tk.scan_tickets_plain(tstate0, raw)

    p_plain = scan_plain()

    def summary_kernel():
        return pallas_ops.summary_lengths(mout)

    rows = [
        dict(name="ticket_scan", variant="no_kind", source="fluidframework_"
             "tpu_torch/kernels/csrc/ticket_scan.cu",
             replaces="fluidframework_tpu/server/ticket_kernel.py:192",
             on_main_path=True, launches=launches["ticket_scan"],
             err=max_abs_err(scan_kernel()[0] + scan_kernel()[1],
                             p_plain[0] + p_plain[1]),
             ms=ms_of(scan_kernel, 20),
             device_ms=one_kernel_ms(scan_kernel, 20, "ticket_scan_kernel"),
             plain_ms=ms_of(scan_plain, 1), library_ms=None,
             shape=f"{DOCS} x T {OPS} x K {TICKET_K}",
             bytes=ticket_scan_bytes(DOCS, OPS, TICKET_K, False),
             ops=ticket_scan_ops(raw, p_plain[1], p_plain[0].overflow,
                                 TICKET_K)),
        dict(name="selftest", variant=None, source="fluidframework_tpu_"
             "torch/kernels/csrc/selftest.cu",
             replaces="fluidframework_tpu/mergetree/pallas_ops.py:42",
             on_main_path=False, launches=launches["selftest"],
             err=max_abs_err([kernels.selftest(x)], [x * 2]),
             ms=ms_of(lambda: kernels.selftest(x), 200),
             device_ms=one_kernel_ms(lambda: kernels.selftest(x), 200,
                                     "selftest_kernel"),
             plain_ms=ms_of(lambda: kernels.selftest_plain(x), 200),
             library_ms=ms_of(lambda: torch.mul(x, 2), 200),
             bytes=8 * 128 * 4 * 2, ops=8 * 128),
        dict(name="summary_len", variant=None, source="fluidframework_tpu_"
             "torch/kernels/csrc/summary_len.cu",
             replaces="fluidframework_tpu/mergetree/pallas_ops.py:58",
             on_main_path=True, launches=launches["summary_len"],
             err=max_abs_err([summary_kernel()],
                             [pallas_ops.summary_lengths_plain(mout)]),
             ms=ms_of(summary_kernel, 50),
             cold_ms=cold_ms(summary_kernel, 20),
             cold_device_ms=cold_device_ms(summary_kernel, 20,
                                           "summary_len_kernel"),
             device_ms=one_kernel_ms(summary_kernel, 50,
                                     "summary_len_kernel"),
             plain_ms=ms_of(lambda: pallas_ops.summary_lengths_plain(mout),
                            10),
             library_ms=None, bytes=summary_bytes,
             ops=DOCS * CAPACITY * 6),
        dict(name="fused_apply", variant="plain", source="fluidframework_"
             "tpu_torch/kernels/csrc/fused_apply.cu",
             replaces="fluidframework_tpu/mergetree/pallas_apply.py:462",
             on_main_path=True, launches=launches["fused_apply[plain]"],
             err=max_abs_err(pallas_apply.apply_ops_fused(mstate0, admitted),
                             p_mout),
             ms=ms_of(lambda: pallas_apply.apply_ops_fused(mstate0,
                                                           admitted), 5),
             device_ms=one_kernel_ms(
                 lambda: pallas_apply.apply_ops_fused(mstate0, admitted), 5,
                 "fused_apply_kernel"),
             path=geo.path,
             paths=path_times(mstate0, admitted, None, False, 5),
             plain_ms=ms_of(lambda: pallas_apply.apply_ops_fused_plain(
                 mstate0, admitted), 1),
             library_ms=None,
             bytes=fused_apply_bytes(DOCS, CAPACITY, OPS, 3, ANNO, False,
                                     False),
             ops=fused_apply_lane_ops(admitted.kind.cpu().numpy(),
                                      live_slots(mstate0, admitted), 3,
                                      ANNO),
             ops_every_slot=fused_apply_lane_ops(
                 admitted.kind.cpu().numpy(), CAPACITY, 3, ANNO)),
    ]
    check_paths(f"north-star [{DOCS} x {CAPACITY}] x T {OPS}", rows[-1],
                card)
    print_ticket_row(rows[0], card, "5")
    sl = rows[2]
    sl_bound = sl["bytes"] / PEAK_BYTES_PER_S * 1e3
    share = (f"{sl_bound / sl['cold_device_ms']:.1%}"
             if sl["cold_device_ms"] else "not measured")
    print(f"phase 5: summary_len [{DOCS} x {CAPACITY}]: warm (the table "
          f"L2-resident after the apply) {fmt_ms(sl['device_ms'])} "
          f"device, {sl['ms']:.4f} ms back to back; cold (L2 flushed "
          f"before each launch) {fmt_ms(sl['cold_device_ms'])} device, "
          f"{sl['cold_ms']:.4f} ms by events around one launch (host "
          f"launch latency included); bound {sl_bound:.5f} ms "
          f"({summary_bytes} bytes over 3.35 TB/s): {share} of the "
          f"bound cold (device); card {card}", flush=True)
    # Phase 23 (a) holds the sharded step to this run's unsharded one.
    north = {"raw": raw, "ops": ops, "fresh": fresh, "p50": p50,
             "out": (tout, mout, ticketed, total)}
    del tstate0, mstate0, mout, p_mout, tout, p_tout, ticketed, p_ticketed
    del admitted, p_plain

    if not north_star_only:
        try:
            clock.mark("phases 6-8")
            rows += serving_phases(dev, card)
            clock.mark("phase 9")
            fuzz_phase(dev)
            clock.mark("phase 10")
            scan_fuzz_phase(dev, early["scan"])
            clock.mark("phase 11")
            rows += scan_full_step_phase(dev, card)
            catchup_rows, catchup_entries, catchup_ms = catchup_phases(
                dev, card)
            rows += catchup_rows
            clock.mark("phase 12")
            paged_rows, hot = paged_phase(dev, card)
            rows += paged_rows
            clock.mark("phase 13")
            scalar_phase(dev, card, catchup_entries, scalar_twin)
            clock.mark("phase 14")
            rows += summarize_phase(dev, card, hot, catchup_entries)
            del hot
        except BaseException:
            stop_twins(lane_twins.values())
            raise
        print(f"phases 1-14 ({time.perf_counter() - twins_from:.1f} s) ran "
              f"beside phase 15's CPU twins (two processes of "
              f"{LANE_CPU_THREADS} threads) and phase 22's (one process of "
              f"{CAPACITY_CPU_THREADS}, from the build on): their "
              f"host-clock figures (the rings' stages, the catch-up's wall "
              f"and host ms, the summarize passes) shared the host with "
              f"them", flush=True)
        clock.mark("phase 15")
        # Each of phases 16 and 17 starts its CPU twins while the phase
        # before waits for its own.
        lambda_twins, server_twins = {}, {}
        rows += lane_store_phase(
            dev, card, lane_twins,
            after_card=lambda: lambda_twins.update(start_lambda_twins()))
        clock.mark("phase 16")
        state = "was still running" if capacity_twin.poll() is None \
            else "had finished"
        print(f"phase 22 (a)'s CPU twin {state} when phase 16 began",
              flush=True)
        z0 = zamboni_counts()
        rows += lambda_phase(
            dev, card, lambda_twins,
            after_card=lambda: server_twins.update(start_server_twins()))
        print_zamboni_launches("16", z0)
        clock.mark("phase 17")
        decay_twin = start_operator_twin("decay")
        try:
            z0 = zamboni_counts()
            server_rows, fig17 = server_phase(dev, card, server_twins)
            rows += server_rows
            print_zamboni_launches("17", z0)
        except BaseException:
            stop_twins([decay_twin])
            raise
        clock.mark("phase 18")
        client_twin = start_client_twin()
        app_twin = start_app_twin()
        try:
            rows += operator_phase(dev, card, decay_twin, fig17["bucketed"],
                                   early)
        except BaseException:
            stop_twins([client_twin, app_twin])
            raise
        print("phase 18 ran beside its decay and server CPU twins and "
              "the CPU twins of phase 19 (a) and phase 20 (b) (processes "
              f"of {CLIENT_CPU_THREADS} and {APP_CPU_THREADS} threads): its "
              "host-clock figures shared the host with them", flush=True)
        clock.mark("phase 19")
        try:
            rows += client_phase(dev, card, catchup_ms, client_twin)
        except BaseException:
            stop_twins([app_twin])
            raise
        clock.mark("phase 20")
        rows += offline_phase(dev, card, app_twin)
        clock.mark("phase 21")
        rows += services_phase(dev, card)
        clock.mark("phase 22")
        z0 = zamboni_counts()
        rows += capacity_phase(dev, card, capacity_twin)
        print_zamboni_launches("22", z0)
        clock.mark("phase 23")
        z0 = zamboni_counts()
        mesh_phase(dev, card, north, fig17)
        print_zamboni_launches("23", z0)
        clock.mark("phase 24")
        z0 = zamboni_counts()
        lint_lock_phase(dev, card, gates_twin)
        print_zamboni_launches("24", z0)
    del north
    clock.mark("the kernels' line")
    clock.close()

    require(not spilled, f"kernels use stack or spill: {spilled}")
    if not north_star_only:
        sources = {r["source"] for r in rows}
        every = {f"fluidframework_tpu_torch/kernels/csrc/{p.name}"
                 for p in build.CSRC.glob("*.cu")}
        require(sources == every, f"the kernels line lacks the sources "
                f"{sorted(every - sources)}")
    out = []
    for r in rows:
        b_ms = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        o_ms = r["ops"] / PEAK_OPS_PER_S * 1e3
        require(r["err"] == 0, f"{r['name']}: max_abs_err {r['err']}")
        row = {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "variant": r["variant"],
            "launches": r["launches"], "on_main_path": r["on_main_path"],
            "max_abs_err": r["err"], "bit_exact": True, "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": r["library_ms"]}
        if "ops_every_slot" in r:  # the apply kernels: both work counts
            every = r["ops_every_slot"]
            row.update(
                bound_ms_every_slot=max(b_ms, every / PEAK_OPS_PER_S * 1e3),
                bound_ms_every_slot_fp32_peak=max(
                    b_ms, every / PEAK_FP32_OPS_PER_S * 1e3))
        if "sms" in r:  # the scan rows: the bound on the SMs it can use
            row["bound_ms_sms"] = max(b_ms, r["ops"] / (
                PEAK_OPS_PER_S * r["sms"] / SM_COUNT) * 1e3)
        row.update({key: r[key] for key in ("path", "paths", "shape",
                                            "device_ms_by", "sms",
                                            "blocks", "threads", "cold_ms",
                                            "cold_device_ms")
                    if key in r})
        out.append(row)
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s, the "
          f"kernel build included; card {card}", flush=True)
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def print_ticket_row(r: dict, card: str, phase: str) -> None:
    bound = max(r["bytes"] / PEAK_BYTES_PER_S, r["ops"] / PEAK_OPS_PER_S)
    share = (f"{bound * 1e3 / r['device_ms']:.1%}" if r["device_ms"]
             else "not measured")
    print(f"phase {phase}: ticket_scan[{r['variant']}] {r['shape']}: "
          f"{fmt_ms(r['device_ms'])} kernel device time, {r['ms']:.4f} ms "
          f"back to back, {r['launches']} launch(es) on the main path; "
          f"bound {bound * 1e3:.5f} ms ({r['bytes']} bytes, {r['ops']} "
          f"lane ops): {share}; plain {r['plain_ms']:.3f} ms; max_abs_err "
          f"{r['err']}; card {card}", flush=True)


def ticket_phase(dev) -> None:
    """Phase 2b: the ticket-scan kernel bit-exact against
    scan_tickets_plain over TICKET_SLOTS x TICKET_MODES x TICKET_STEPS x
    TICKET_BATCHES, each case two windows (the second continues the
    state the kernel left), on testing/traces.raw_ticket_trace messages
    from K + 3 clients: joins, leaves, duplicates, stale refs, SYSTEM
    messages, unknown clients and overflowing tables. Every call with
    messages launches once; T = 0 launches nothing and returns the state
    as it was."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing.traces import raw_ticket_trace

    t0 = time.perf_counter()
    big = max(TICKET_BATCHES)
    checked = 0
    seen = dict.fromkeys(("overflow", "not_joined", "stale", "dup",
                          "slot_32_used"), False)
    for k in TICKET_SLOTS:
        for with_kind, require_join in TICKET_MODES:
            for t in TICKET_STEPS:
                seed = 1000 * k + 100 * with_kind + 10 * require_join + t
                windows = [interop.raw_ops_from_numpy(raw_ticket_trace(
                    seed + w, big, t, n_clients=k + 3, with_kind=with_kind),
                    dev) for w in range(2)]
                want, s = [], tk.make_ticket_state(k, big, device=dev)
                for ops in windows:
                    s, out = tk.scan_tickets_plain(s, ops, require_join)
                    want.append((s, out))
                what = (f"ticket_scan K={k} kind={with_kind} "
                        f"require_join={require_join} T={t}")
                for b in TICKET_BATCHES:
                    s = rows_of(tk.make_ticket_state(k, big, device=dev), b)
                    for w, ops in enumerate(windows):
                        n0 = tk.scan_tickets.launches
                        s_in = s
                        s, out = tk.scan_tickets(s, rows_of(ops, b),
                                                 require_join)
                        torch.cuda.synchronize()
                        n = tk.scan_tickets.launches - n0
                        require(n == (t > 0), f"{what} B={b}: {n} launches")
                        if t == 0:
                            require(s is s_in and out.seq.shape == (b, 0),
                                    f"{what} B={b}: T = 0 changed the state")
                        assert_tuple_equal(s, rows_of(want[w][0], b),
                                           f"{what} B={b} window {w} state")
                        assert_tuple_equal(out, rows_of(want[w][1], b),
                                           f"{what} B={b} window {w} "
                                           "outputs")
                        checked += 1
                if t == 0:
                    continue
                for (st, out), ops in zip(want, windows):
                    is_op = ops.client >= 0 if ops.kind is None else \
                        (ops.kind == tk.MsgKind.OP) & (ops.client >= 0)
                    seen["overflow"] |= bool(st.overflow.any())
                    seen["not_joined"] |= bool(out.not_joined.any())
                    seen["stale"] |= bool((out.nacked
                                           & ~out.not_joined).any())
                    seen["dup"] |= bool((is_op & (out.seq == 0)
                                         & ~out.nacked).any())
                    seen["slot_32_used"] |= k > 32 and bool(
                        (st.client_ids[:, 32:] >= 0).any())
    require(all(seen.values()), f"phase 2b: the grid missed a case: {seen}")
    print(f"phase 2b: ticket_scan bit-exact against scan_tickets_plain in "
          f"{checked} calls (K {TICKET_SLOTS} x kind / require_join "
          f"{TICKET_MODES} x T {TICKET_STEPS} x B {TICKET_BATCHES} x 2 "
          f"windows), reaching {sorted(seen)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def serving_phases(dev, card: str) -> list:
    """Phases 6-8, the paged serving megakernel; returns the kernel rows
    of the ticket scan at the ring's shape and of the fused apply's
    extract and runs+extract variants."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import oppack
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree.paging import PagedMergeStore
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import serve_step
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.server.lww_kernel import make_lww_state
    from fluidframework_tpu_torch.testing import golden, serving
    from fluidframework_tpu_torch.testing.traces import (gen_run_traces,
                                                         gen_traces)

    require(oppack.RUN_K == RUN_K, "RUN_K differs from mergetree/oppack")

    # -- phase 6: the runs= and extract=True variants vs plain -----------
    def check_variants(what, state, cols, runs_np):
        ops = interop.packed_ops_from_numpy(cols, dev)
        runs = interop.run_cols_from_numpy(runs_np, dev)
        plain_ops = interop.packed_ops_from_numpy(
            gen_traces(state.length.shape[0], cols["kind"].shape[1],
                       seed=7), dev)
        for o, r, ex in ((ops, runs, False), (plain_ops, None, True),
                         (ops, runs, True)):
            got = pa.apply_ops_fused(state, o, runs=r, extract=ex)
            want = pa.apply_ops_fused_plain(state, o, runs=r, extract=ex)
            torch.cuda.synchronize()
            assert_trees_equal(got, want, f"{what} "
                               f"[{pa.variant_name(r, ex)}]")
        print(f"phase 6: runs / extract / runs+extract bit-exact: {what}",
              flush=True)

    cols, runs = gen_run_traces(VARIANT_BATCH, 64, seed=11)
    check_variants(f"gen_run_traces({VARIANT_BATCH}, 64) C=512",
                   make_state(512, A_SLOTS, batch=VARIANT_BATCH,
                              device=dev), cols, runs)
    cols, runs = gen_run_traces(8, 6, seed=12)
    check_variants("C=1100, 1030 rows: shifts by 8 across the chunk "
                   "boundary", long_table(dev, 8, 1100, 1030), cols, runs)
    cols, runs = gen_run_traces(128, 100, seed=13)
    check_variants("1,024-row page-group view, gen_run_traces(128, 100)",
                   make_state(1024, A_SLOTS, batch=128, device=dev),
                   cols, runs)

    # -- phase 7: the golden ring vs the JAX outputs ---------------------
    g = golden.load(golden.SERVE_GOLDEN_PATH)
    n_lww = sum(1 for k in g if k.startswith("lww_in_"))
    ring = interop.ring_args_from_numpy(serving.ring_from_arrays(g["ring"]),
                                        dev)
    ts, pool, lww, flat16_k, msn_k, pre = serve_step.serve_megakernel(
        interop.ticket_state_from_numpy(g["tstate_in"], dev),
        interop.page_pool_from_numpy(g["pool_in"], dev),
        [interop.lww_state_from_numpy(g[f"lww_in_{i}"], dev)
         for i in range(n_lww)], *ring, stats=True)
    assert_matches_numpy(ts, g["tstate_out"], "golden ring tstate")
    assert_matches_numpy(pool, g["pool_out"], "golden ring pool")
    for i, s in enumerate(lww):
        assert_matches_numpy(s, g[f"lww_out_{i}"], f"golden ring lww {i}")
    for i, v in enumerate(pre):
        assert_matches_numpy(v, g[f"pre_{i}"], f"golden ring pre view {i}")
    require(np.array_equal(flat16_k.cpu().numpy(), g["wire"]["flat16_k"]),
            "golden ring flat16_k")
    require(np.array_equal(msn_k.cpu().numpy(), g["wire"]["msn_k"]),
            "golden ring msn_k")
    print("phase 7: serve_megakernel equals the JAX golden ring (tstate, "
          "pool, LWW, flat16_k, msn_k, pre views)", flush=True)

    # -- phase 8: two full-size rings through the kernels ----------------
    fleet = serving.ServingFleet(getattr(serving, RING_SPEC), seed=0)
    spec = fleet.spec
    store = PagedMergeStore(pages=16384, device=dev)
    plain_serve = serve_step.make_serve_megakernel(keep=True, plain=True)
    wrappers = (pa.apply_ops_fused,)

    def run_ring(ts, lww):
        t0 = time.perf_counter()
        staged = fleet.stage_ring(store)
        stage_s = time.perf_counter() - t0
        args = interop.ring_args_from_numpy(staged.args, dev)
        pool_pre = type(store.pool)(*(t.clone() for t in store.pool))
        want = plain_serve(ts, pool_pre, lww, *args, stats=True)
        torch.cuda.synchronize()
        pa.reset_launches()
        tk.scan_tickets.launches = 0
        reset_window_counts()
        with PlainLwwGuard() as guard:
            got = serve_step.serve_megakernel(ts, store.pool, lww, *args,
                                              stats=True)
            torch.cuda.synchronize()
        counts = dict(wrappers[0].variant_launches)
        counts["ticket_scan"] = tk.scan_tickets.launches
        counts.update(window_counts())
        paths = dict(wrappers[0].path_launches)
        assert_trees_equal(got, want, "ring vs the plain composition")
        require(counts["ticket_scan"] == spec.windows,
                f"ring: {counts['ticket_scan']} ticket_scan launches for "
                f"{spec.windows} windows")
        require_window_launches("phase 8 ring", counts, guard, spec.windows,
                                len(args.merge_xs), len(args.lww_xs))
        expect = dict.fromkeys(paths, 0)
        for gi, view in enumerate(got[5]):
            b, c = view.length.shape
            expect[pa.launch_geometry(b, c, K_SLOTS, A_SLOTS).path] += \
                args.merge_xs[gi].shape[0]
        require(paths == expect, f"ring path launches {paths}, the rule "
                f"names {expect}")
        b, t = spec.docs, spec.steps
        layout = serve_step.flat16_layout(b, t, staged.merge_lanes,
                                          staged.lww_lanes, True, True)
        lo, _hi = layout["overflow"]
        over = got[3][-1, lo:lo + sum(staged.merge_lanes)].cpu().numpy()
        expected = np.concatenate(staged.expected_overflow)
        require(np.array_equal(over != 0, expected),
                f"ring overflow lanes {np.flatnonzero(over)} differ from "
                f"the mispredicted-run lanes {np.flatnonzero(expected)}")
        serving.adopt_ring(store, staged, got[3][-1].cpu().numpy(),
                           stats=True)
        return staged, args, pool_pre, got, counts, stage_s

    ts0 = tk.make_ticket_state(serving.TICKET_CLIENTS, spec.docs,
                               device=dev)
    lww0 = [make_lww_state(spec.lww_capacity, fleet.lww_lanes, device=dev)]
    r1 = run_ring(ts0, lww0)
    print(f"phase 8: ring 1 (from empty) {r1[0].counts}, groups "
          f"{[tuple(p.shape) for p in r1[0].args.page_ids]}, staged in "
          f"{r1[5]:.2f} s, equal to the plain composition, each group on "
          "its rule's path", flush=True)
    ts1, lww1 = r1[3][0], r1[3][2]
    staged, args, pool_pre, got, counts, stage_s = run_ring(ts1, lww1)
    require(counts["extract"] > 0 and counts["runs_extract"] > 0,
            f"the ring did not launch both variants: {counts}")
    print(f"phase 8: ring 2 {staged.counts}, groups "
          f"{[tuple(p.shape) for p in staged.args.page_ids]} x Tm "
          f"{[m.shape[-1] for m in staged.args.merge_xs]}, pages in use "
          f"{store.pages_in_use}, staged in {stage_s:.2f} s; launches "
          f"{counts}, paths {dict(pa.apply_ops_fused.path_launches)}; equal "
          "to the plain composition; overflow only on "
          f"the {staged.counts['mispredicted_docs']} mispredicted-run "
          "lanes", flush=True)

    trials = [ring_trial(serve_step.serve_megakernel, ts1, pool_pre, lww1,
                         args) for _ in range(TRIALS)]
    splits = [ring_trial(serve_step.serve_megakernel, ts1, pool_pre, lww1,
                         args, RING_STAGES)[2] for _ in range(TRIALS)]
    ring_ms = float(np.median([t[0] for t in trials]))
    host_ms = float(np.median([t[1] for t in trials]))
    split = {k: round(float(np.median([s[k] for s in splits])), 3)
             for k in RING_STAGES}
    n_ops = staged.counts["merge_ops"] + staged.counts["lww_ops"]
    pool_copy = type(pool_pre)(*(t.clone() for t in pool_pre))
    trace = kernel_device_ms(lambda: serve_step.serve_megakernel(
        ts1, pool_copy, lww1, *args, stats=True), 1)
    if trace:
        busy = sum(ms for ms, _n in trace.values())
        apply_ms = sum(ms for name, (ms, _n) in trace.items()
                       if "fused_apply_kernel" in name)
        print(f"serve_megakernel ring device trace (torch.profiler, one "
              f"ring): {sum(n for _ms, n in trace.values()):.0f} kernel "
              f"launches, device busy {busy:.3f} ms of the {ring_ms:.3f} "
              f"ms p50 ring (idle share {1 - busy / ring_ms:.3f}), "
              f"fused_apply kernels {apply_ms:.3f} ms", flush=True)
    else:
        print("serve_megakernel ring device trace: not measured "
              "(torch.profiler recorded no device activity)", flush=True)
    print(f"serve_megakernel ring: {n_ops / (ring_ms / 1e3):.0f} ops/s "
          f"({staged.counts['merge_ops']} merge + "
          f"{staged.counts['lww_ops']} LWW ops, "
          f"{staged.counts['messages']} messages), p50 {ring_ms:.3f} ms "
          f"(host clock p50 {host_ms:.3f} ms, trials "
          f"{[round(t[0], 3) for t in trials]}), stage p50 ms {split}; "
          f"card {card}", flush=True)

    # -- per-kernel numbers at the ring's shapes: window 0 of ring 2 -------
    raw0 = tk.RawOps(client=args.ticket_xs[0, 1],
                     client_seq=args.ticket_xs[0, 2],
                     ref_seq=args.ticket_xs[0, 3], kind=args.ticket_xs[0, 0])

    def scan_kernel():
        return tk.scan_tickets(ts1, raw0, require_join=True)

    def scan_plain():
        return tk.scan_tickets_plain(ts1, raw0, require_join=True)

    p_plain = scan_plain()

    _ts, ticketed = scan_kernel()
    k_slots = ts1.client_ids.shape[1]
    ticket_row = dict(
        name="ticket_scan", variant="kind_require_join",
        source="fluidframework_tpu_torch/kernels/csrc/ticket_scan.cu",
        replaces="fluidframework_tpu/server/ticket_kernel.py:192",
        on_main_path=True, launches=counts["ticket_scan"],
        err=max_abs_err(scan_kernel()[0] + scan_kernel()[1],
                        p_plain[0] + p_plain[1]),
        ms=ms_of(scan_kernel, 20),
        device_ms=one_kernel_ms(scan_kernel, 20, "ticket_scan_kernel"),
        plain_ms=ms_of(scan_plain, 1), library_ms=None,
        shape=f"{spec.docs} x T {spec.steps} x K {k_slots} (ring 2, window "
              "0)",
        bytes=ticket_scan_bytes(spec.docs, spec.steps, k_slots, True),
        ops=ticket_scan_ops(raw0, p_plain[1], p_plain[0].overflow, k_slots))
    print_ticket_row(ticket_row, card, "8")
    per_group = []
    for gi, view in enumerate(got[5]):
        ops2, runs, _over = serve_step.admit_merge_ops(
            ticketed.seq, ticketed.min_seq, args.merge_xs[gi][0],
            None if args.runs_xs[gi] is None else args.runs_xs[gi][0])
        b, c = view.length.shape
        kern = pa.apply_ops_fused(view, ops2, runs=runs, extract=True)
        plain = pa.apply_ops_fused_plain(view, ops2, runs=runs,
                                         extract=True)
        torch.cuda.synchronize()
        variant = pa.variant_name(runs, True)
        r = dict(
            name=f"fused_apply_{variant}", variant=variant, group=gi,
            source="fluidframework_tpu_torch/kernels/csrc/fused_apply.cu",
            replaces="fluidframework_tpu/mergetree/pallas_apply.py:462",
            on_main_path=True, launches=counts[variant],
            err=max_abs_err(kern[0] + kern[1], plain[0] + plain[1]),
            ms=ms_of(lambda: pa.apply_ops_fused(view, ops2, runs=runs,
                                                extract=True), 20),
            device_ms=one_kernel_ms(lambda: pa.apply_ops_fused(
                view, ops2, runs=runs, extract=True), 20,
                "fused_apply_kernel"),
            path=pa.launch_geometry(b, c, K_SLOTS, A_SLOTS).path,
            paths=path_times(view, ops2, runs, True, 20),
            plain_ms=ms_of(lambda: pa.apply_ops_fused_plain(
                view, ops2, runs=runs, extract=True), 1),
            library_ms=None, cells=b * c,
            bytes=fused_apply_bytes(b, c, ops2.steps, K_SLOTS, A_SLOTS,
                                    runs is not None, True),
            ops=fused_apply_lane_ops(ops2.kind.cpu().numpy(),
                                     live_slots(view, ops2, runs), K_SLOTS,
                                     A_SLOTS),
            ops_every_slot=fused_apply_lane_ops(ops2.kind.cpu().numpy(), c,
                                                K_SLOTS, A_SLOTS))
        bound = max(r["bytes"] / PEAK_BYTES_PER_S,
                    r["ops"] / PEAK_OPS_PER_S) * 1e3
        print(f"  fused_apply[{variant}] window 0 of group {gi} "
              f"[{b} x {c}] x Tm {ops2.steps}: {r['ms']:.4f} ms back to "
              f"back, {fmt_ms(r['device_ms'])} kernel device time (bound "
              f"{bound:.4f} ms over the rows in use), plain "
              f"{r['plain_ms']:.3f} ms, max_abs_err {r['err']}", flush=True)
        check_paths(f"group {gi}", r, card)
        require(r["err"] == 0, f"group {gi}: kernel vs plain differ")
        per_group.append(r)
    # the JSON row of a variant is its largest group
    rows = [ticket_row]
    for variant in ("extract", "runs_extract"):
        mine = [r for r in per_group if r["variant"] == variant]
        require(bool(mine), f"no page group runs the {variant} variant")
        rows.append(max(mine, key=lambda r: r["cells"]))
    return rows + window_rows(dev, card, ts1, got[5], lww1, args, ticketed,
                              counts)


WINDOW_SOURCES = {
    "lww_scan": ("fluidframework_tpu_torch/kernels/csrc/lww_scan.cu",
                 "fluidframework_tpu/server/lww_kernel.py:102"),
    "window_admit": ("fluidframework_tpu_torch/kernels/csrc/window_admit.cu",
                     "fluidframework_tpu/server/serve_step.py:39"),
    "window_pack": ("fluidframework_tpu_torch/kernels/csrc/window_pack.cu",
                    "fluidframework_tpu/server/serve_step.py:39"),
}
WINDOW_KERNELS = ("lww_scan_kernel", "window_admit_kernel",
                  "window_pack_kernel")
LWW_BUCKET_C = 16_384   # the lane store's last key-capacity bucket
LWW_BUCKET_T = 4


def require_window_launches(what: str, counts: dict, guard, windows: int,
                            groups: int, buckets: int) -> None:
    """A window path's launches of the window's kernels: one pack a
    window, one admission a group a window, one LWW scan a bucket a
    window; and no plain LWW call on the card's tensors."""
    want = {"window_pack": windows, "window_admit": windows * groups,
            "lww_scan": windows * buckets}
    got = {k: counts.get(k, 0) for k in want}
    require(got == want, f"{what}: the window's kernels launched {got}, "
            f"expected {want}")
    require(guard.cuda_calls == 0, f"{what}: the plain LWW scan ran "
            f"{guard.cuda_calls} times on the card's tensors")


def lww_work(state, kinds) -> tuple:
    """(bytes, operations) of one LWW scan: the table read and written
    once, and per real op a sweep of its C slots (two compares a slot for
    SET, one for DELETE and CLEAR; one add for ADD)."""
    b, c = state.key.shape
    k = kinds.cpu().numpy()
    table = b * (c * 12 + 9)
    ops = c * (2 * int((k == 1).sum()) + int(((k == 2) | (k == 3)).sum())) \
        + int((k == 4).sum())
    return 2 * table, ops


def window_row(name: str, variant: str, card: str, launches: int, fn, plain,
               flat, kernel: str, shape: str, nbytes: int, ops: int) -> dict:
    """A kernel row of the serving window's kernels: bit-exact against the
    plain version on the same inputs, timed back to back and by the
    profiler, printed beside its bound."""
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(flat(got), flat(want))
    r = dict(name=name, variant=variant, source=WINDOW_SOURCES[name][0],
             replaces=WINDOW_SOURCES[name][1], on_main_path=True,
             launches=launches, err=err, ms=ms_of(fn, 20),
             device_ms=one_kernel_ms(fn, 20, kernel),
             plain_ms=ms_of(plain, 1), library_ms=None, shape=shape,
             bytes=nbytes, ops=ops)
    bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S) * 1e3
    dev_ms = r["device_ms"]
    share = f"{bound / dev_ms:.1%}" if dev_ms else "not measured"
    print(f"  {name}[{variant}] {shape}: {fmt_ms(dev_ms)} kernel device "
          f"time, {r['ms']:.4f} ms back to back, plain {r['plain_ms']:.3f} "
          f"ms; bound {bound:.5f} ms ({nbytes} bytes, {ops} operations): "
          f"{share} of the bound; max_abs_err {err}; launches on the main "
          f"path {launches}; card {card}", flush=True)
    require(err == 0, f"{name}[{variant}] {shape}: kernel vs plain differ")
    return r


def flat_tree(x) -> list:
    """The tensors of a (nested) tuple, None dropped."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in flat_tree(part)]


def window_rows(dev, card: str, ts, views, lww, args, ticketed,
                counts: dict) -> list:
    """The serving window's kernels at ring 2's window 0 (the admission of
    every group, the row its largest; the LWW bucket in the admit mode;
    the pack of the whole window) and the LWW scan on one lane-store
    bucket of LWW_BUCKET_C slots, each bit-exact against its plain
    version and timed against its bound."""
    from fluidframework_tpu_torch.server import lww_kernel as lk
    from fluidframework_tpu_torch.server import serve_step as ss
    seq, msn = ticketed.seq, ticketed.min_seq
    b, t = seq.shape
    admit_rows = []
    for gi, mc in enumerate(args.merge_xs):
        mc0 = mc[0]
        mr0 = None if args.runs_xs[gi] is None else args.runs_xs[gi][0]
        lanes, tm = mc0.shape[1:]
        k = 0 if mr0 is None else mr0.shape[-1]
        # read: the kind, doc and step columns, each op's two gathers (and
        # each member's length, doc, step and gather); written: kind, seq,
        # msn (and each member's seq, each lane's flag)
        nbytes = lanes * tm * (3 * 4 + 2 * 4 + 3 * 4) + \
            lanes * tm * k * (4 * 4 + 4) + (lanes if k else 0)
        admit_rows.append(window_row(
            "window_admit", "runs" if k else "plain", card,
            counts["window_admit"],
            lambda mc0=mc0, mr0=mr0: ss.admit_merge_ops(seq, msn, mc0, mr0),
            lambda mc0=mc0, mr0=mr0: ss.admit_merge_ops_plain(seq, msn, mc0,
                                                              mr0),
            flat_tree, "window_admit_kernel",
            f"group {gi} [{lanes} lanes x Tm {tm}, RUN_K {k}] (ring 2, "
            f"window 0)", nbytes, lanes * tm * (2 + 2 * k)))
    rows = [max(admit_rows, key=lambda r: r["bytes"])]

    lc0 = args.lww_xs[0][0]
    lanes, tm = lc0.shape[1:]
    window = lk.apply_lww_window_plain(lww[0], lc0, seq)
    table, ops = lww_work(lww[0], window[1])
    rows.append(window_row(
        "lww_scan", "window", card, counts["lww_scan"],
        lambda: lk.apply_lww_window(lww[0], lc0, seq),
        lambda: lk.apply_lww_window_plain(lww[0], lc0, seq), flat_tree,
        "lww_scan_kernel",
        f"[{lanes} lanes x C {lww[0].key.shape[1]}] x Tm {tm} (ring 2, "
        "window 0)", table + lanes * tm * (6 * 4 + 4 + 4) + lanes * 4, ops))

    captured = {}
    real = ss._pack_launch

    def capture(*a):
        captured["args"] = a
        return real(*a)
    ss._pack_launch = capture
    try:
        ss._serve_window_impl(
            ts, args.ticket_xs[0], list(views), [m[0] for m in args.merge_xs],
            list(lww), [x[0] for x in args.lww_xs],
            [None if r is None else r[0] for r in args.runs_xs],
            noop_skip=True, stats=True, paged_scalars=True)
        torch.cuda.synchronize()
    finally:
        ss._pack_launch = real
    pack_args = captured["args"]
    nbytes = b * (4 + 1) + b * t * (4 + 4 + 1 + 1)
    for over, count, kinds in pack_args[2] + pack_args[4]:
        nbytes += over.numel() * (1 + 4) + kinds.numel() * 4
    nbytes += sum(x.numel() * x.element_size() for nr in pack_args[3]
                  for x in nr)
    out = ss._pack_window_plain(*pack_args)
    rows.append(window_row(
        "window_pack", "paged_stats", card, counts["window_pack"],
        lambda: ss._pack_window(*pack_args),
        lambda: ss._pack_window_plain(*pack_args), flat_tree,
        "window_pack_kernel",
        f"[{b} x T {t}], {len(pack_args[2])} groups, {len(pack_args[4])} "
        f"LWW buckets, {out.numel()} int16 (ring 2, window 0)",
        nbytes + out.numel() * 2, b * t * 8))

    rng = np.random.default_rng(19)
    c = LWW_BUCKET_C
    key = rng.integers(0, 2 * c, (1, c)).astype(np.int32)
    key[rng.random((1, c)) < 0.5] = -1
    state = lk.LwwState(
        key=torch.from_numpy(key).to(dev),
        val=torch.from_numpy(np.where(key >= 0, 7, -1).astype(np.int32)
                             ).to(dev),
        seq=torch.ones((1, c), dtype=torch.int32, device=dev),
        counter=torch.zeros(1, dtype=torch.int32, device=dev),
        last_seq=torch.zeros(1, dtype=torch.int32, device=dev),
        overflow=torch.zeros(1, dtype=torch.bool, device=dev))
    present = key[key >= 0]
    ops = lk.LwwOps(*(torch.tensor([col], dtype=torch.int32, device=dev)
                      for col in ([1, 1, 2, 4],
                                  [int(present[-1]), 3 * c, int(present[0]),
                                   0], [70, 71, 72, 73], [0, 0, 0, -4],
                                  [10, 11, 12, 13])))
    table, n_ops = lww_work(state, ops.kind)
    rows.append(window_row(
        "lww_scan", "bucket", card, counts["lww_scan"],
        lambda: lk.apply_lww_batched(state, ops),
        lambda: lk.apply_lww_batched_plain(state, ops), flat_tree,
        "lww_scan_kernel",
        f"[1 lane x C {c}] x T {LWW_BUCKET_T} (the lane store's last "
        "bucket)", table + LWW_BUCKET_T * 20, n_ops))
    return rows


def fuzz_phase(dev) -> None:
    """Phase 9: both fused-apply paths, in all four variants, bit-exact
    against the plain version at every capacity of FUZZ_CAPACITIES that
    the path takes: fuzz_tables (empty documents and near-full ones, so
    every capacity gate trips) under gen_fuzz_traces (every op kind, four
    clients, pending local ops and their acks, stale perspectives,
    positions past the end, INSERT_RUN steps with dead members, whose
    8-row shifts and fills straddle the rows of the warp path)."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                         gen_fuzz_traces)
    t0 = time.perf_counter()
    checked = dict.fromkeys(PATHS, 0)
    flagged = 0
    for c in FUZZ_CAPACITIES:
        for k, a in FUZZ_SLOTS:
            for seed in FUZZ_SEEDS:
                tables = fuzz_tables(FUZZ_DOCS, c, k, a, seed=seed)
                state = interop.doc_state_from_numpy(tables, dev)
                length = tables["count"] * 2
                cols = gen_fuzz_traces(FUZZ_DOCS, FUZZ_OPS, seed=seed,
                                       length=length)
                rcols, rruns = gen_fuzz_traces(FUZZ_DOCS, FUZZ_OPS,
                                               seed=seed + 100, runs=True,
                                               length=length)
                cases = []
                for ops, runs in (
                        (interop.packed_ops_from_numpy(cols, dev), None),
                        (interop.packed_ops_from_numpy(rcols, dev),
                         interop.run_cols_from_numpy(rruns, dev))):
                    want = pa.apply_ops_fused_plain(state, ops, runs=runs)
                    flagged += int(want.overflow.sum())
                    cases.append((ops, runs, want))
                for path in PATHS:
                    if path == "warp" and c > pa.WARP_MAX_CAPACITY:
                        continue
                    geo = pa._forced_geometry(path, c, k, a)
                    for ops, runs, want in cases:
                        for ex in (False, True):
                            got = pa._launch(state, ops, runs, ex, geo)
                            torch.cuda.synchronize()
                            assert_trees_equal(
                                got, (want, pa.narrow_of(want)) if ex
                                else want,
                                f"fuzz C={c} K={k} A={a} seed={seed} {path} "
                                f"[{pa.variant_name(runs, ex)}]")
                            checked[path] += 1
    print(f"phase 9: fuzz bit-exact on both paths, {checked} launches "
          f"(4 variants x capacities {FUZZ_CAPACITIES} x (K, A) "
          f"{FUZZ_SLOTS} x seeds {FUZZ_SEEDS}, {FUZZ_DOCS} docs x "
          f"{FUZZ_OPS} ops; {flagged} overflowed documents in the plain "
          f"results), {time.perf_counter() - t0:.1f} s", flush=True)


def fused_takes(pa, capacity: int, k: int, a: int) -> bool:
    """Whether the fused apply takes this shape (at most 32 planes, the
    table in one block's shared memory)."""
    try:
        return capacity <= pa.max_fused_capacity(k, a)
    except ValueError:
        return False


def scan_geometries(batch: int, capacity: int, k: int, a: int) -> dict:
    """{label: ScanGeometry} of every scan-apply path that holds the table,
    at the rule's threads for `batch` documents: global_chunked, global,
    smem, and each cluster of SCAN_CLUSTER_SIZES."""
    from fluidframework_tpu_torch.mergetree import kernel
    out = {p: kernel._forced_geometry(p, capacity, k, a, batch=batch)
           for p in ("global_chunked", "global")}
    try:
        out["smem"] = kernel._forced_geometry("smem", capacity, k, a,
                                              batch=batch)
    except ValueError:
        pass
    for n in SCAN_CLUSTER_SIZES:
        try:
            out[f"cluster{n}"] = kernel._forced_geometry(
                "cluster", capacity, k, a, blocks=n, batch=batch)
        except ValueError:
            pass
    return out


def scan_label(geo) -> str:
    return f"cluster{geo.blocks}" if geo.path == "cluster" else geo.path


def scan_cells() -> tuple:
    """Phase 10's grid: the (C, B, A, steps, seed) cells it checks, and
    the (B, C, A) cells that SCAN_MAX_INTS drops."""
    cells, dropped = [], []
    for ci, c in enumerate(SCAN_CAPACITIES):
        steps = 24 if c <= 4200 else 12 if c <= 16384 else 8
        for b in SCAN_BATCHES:
            for a in SCAN_ANNO:
                if b * c * (8 + 3 + a) > SCAN_MAX_INTS:
                    dropped.append((b, c, a))
                else:
                    cells.append((c, b, a, steps, 1000 + 10 * ci + a))
    return cells, dropped


def scan_tables(cell) -> dict:
    """A phase 10 cell's starting tables (numpy): fuzz_tables, a
    one-document cell taking the near-full document of a fuzzed pair."""
    from fluidframework_tpu_torch.testing.traces import fuzz_tables
    c, b, a, _, seed = cell
    tables = fuzz_tables(max(b, 2), c, 3, a, seed=seed)
    if b == 1:  # the near-full document
        tables = {f: v[1:2] for f, v in tables.items()}
    return tables


def scan_fuzz_phase(dev, early: dict) -> None:
    """Phase 10: every scan-apply path (scan_geometries) bit-exact against
    the plain scan on fuzz_tables under gen_fuzz_traces over
    SCAN_CAPACITIES x SCAN_BATCHES x SCAN_ANNO, plain and runs variants; a
    one-document cell takes the near-full document of a fuzzed pair. Where
    the fused apply takes the capacity, the scan kernel must also equal
    the fused kernel, bit for bit. `early` holds the tables of the largest
    cells, drawn during the kernel build (start_set_up); each is dropped
    once checked."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.testing.traces import gen_fuzz_traces
    t0 = time.perf_counter()
    checked, vs_fused, flagged = {}, 0, 0
    cells, dropped = scan_cells()

    def tables_of(cell):
        return early.pop(cell, None) or scan_tables(cell)

    # The host draws the next cell's tables (most of the phase's time at
    # the large cells) while the card checks this one.
    pool = ThreadPoolExecutor(max_workers=1)
    ahead = pool.submit(tables_of, cells[0])
    for i, (c, b, a, steps, seed) in enumerate(cells):
        tables = ahead.result()
        if i + 1 < len(cells):
            ahead = pool.submit(tables_of, cells[i + 1])
        state = interop.doc_state_from_numpy(tables, dev)
        length = tables["count"] * 2
        geos = scan_geometries(b, c, 3, a)
        for with_runs in (False, True):
            got = gen_fuzz_traces(b, steps, seed=seed + with_runs,
                                  runs=with_runs, length=length)
            cols, run_np = got if with_runs else (got, None)
            ops = interop.packed_ops_from_numpy(cols, dev)
            runs = None if run_np is None else \
                interop.run_cols_from_numpy(run_np, dev)
            want = kernel.scan_ops_plain(state, ops, True, runs)
            flagged += int(want.overflow.sum())
            what = f"scan C={c} B={b} A={a} runs={with_runs}"
            for label, geo in geos.items():
                out = kernel._launch(state, ops, runs, geo)
                torch.cuda.synchronize()
                assert_trees_equal(out, want, f"{what} {label}")
                checked[label] = checked.get(label, 0) + 1
            if fused_takes(pa, c, 3, a):
                fused = pa.apply_ops_fused(state, ops, runs)
                torch.cuda.synchronize()
                assert_trees_equal(want, fused, f"{what} vs fused")
                vs_fused += 1
        del state, out, want, tables
    pool.shutdown()
    print(f"phase 10: every scan_apply path bit-exact against the plain "
          f"scan, launches by path {checked} (capacities "
          f"{SCAN_CAPACITIES} x documents {SCAN_BATCHES} x A {SCAN_ANNO} x "
          f"plain/runs, K=3; {flagged} overflowed documents in the plain "
          f"results), and equal to the fused kernel in the {vs_fused} "
          f"cells where it applies; dropped cells (B, C, A): "
          f"{dropped or 'none'}; {time.perf_counter() - t0:.1f} s",
          flush=True)


def scan_input_facts(state, ops) -> str:
    """What a scan input holds that the path's time may follow: the live
    row counts, how many documents have uniform padding (every plane's
    slots past count hold one value: only those documents' sweeps stop at
    count, scan_apply.cu's header), and the op mix by kind (NOOP, INSERT,
    REMOVE, ANNOTATE, ACK_INSERT, ACK_REMOVE, INSERT_RUN)."""
    b, c = state.length.shape
    rows = torch.arange(b, device=state.length.device)
    first = state.count.clamp(max=c - 1).long()
    pad = torch.arange(c, device=rows.device)[None, :] \
        >= state.count[:, None]
    uniform = torch.ones(b, dtype=torch.bool, device=rows.device)
    for name in ("length", "ins_seq", "ins_client", "local_seq", "rem_seq",
                 "rem_local_seq", "rem_clients", "origin_op", "origin_off",
                 "anno"):
        x = getattr(state, name)
        v = x[rows, first]
        if x.dim() == 2:
            odd = (x != v[:, None]) & pad
        else:
            odd = (x != v[:, None, :]) & pad[..., None]
        uniform &= ~odd.flatten(1).any(dim=1)
    cnt = state.count.cpu().numpy()
    kinds = np.bincount(ops.kind.cpu().numpy().ravel(), minlength=7)
    return (f"counts min/median/max {int(cnt.min())}/"
            f"{int(np.median(cnt))}/{int(cnt.max())} (fill "
            f"{cnt.mean() / c:.3f}), uniform padding "
            f"{int(uniform.sum())}/{b} documents, op kinds {kinds.tolist()}")


def scan_rows(what: str, state, ops, runs, kernel_launches: dict,
              reps: int, shape: str, card: str,
              main_path: bool = True) -> list:
    """The kernel rows of one scan-apply input ([B, C] CUDA tensors) on
    every path (scan_geometries): kernel device ms (CUDA events,
    long_kernel_ms over PATH_REPS single launches) and back-to-back ms
    over `reps`, the launches of the rule's path
    in the main path's run (0 on the other rows), the plain scan's ms,
    the bound's work (the rows
    in use and every slot) and the SMs the launch can occupy. Fails unless
    every path equals the plain scan and, for a main path's input, the
    rule's path is at most PATH_MARGIN slower on the device than the
    fastest."""
    from fluidframework_tpu_torch.mergetree import kernel
    b, c = state.length.shape
    k, a = state.overlap_slots, state.anno_slots
    variant = "runs" if runs is not None else "plain"
    plain_ms, want = plain_once(lambda: kernel.scan_ops_plain(
        state, ops, True, runs))
    kinds = ops.kind.cpu().numpy()
    work = dict(
        bytes=fused_apply_bytes(b, c, ops.steps, k, a, runs is not None,
                                False),
        ops=fused_apply_lane_ops(kinds, live_slots(state, ops, runs), k, a),
        ops_every_slot=fused_apply_lane_ops(kinds, c, k, a))
    rule_geo = kernel.scan_geometry(b, c, k, a)
    rule = scan_label(rule_geo)
    geos = scan_geometries(b, c, k, a)
    require(geos.get(rule) == rule_geo,
            f"scan_apply at {shape}: the rule's {rule_geo} is not among "
            f"the forced geometries")
    rows = []
    for label, geo in geos.items():
        def run(geo=geo):
            return kernel._launch(state, ops, runs, geo)
        r = dict(
            name="scan_apply", variant=variant, shape=shape, path=label,
            blocks=geo.blocks, threads=geo.threads,
            source="fluidframework_tpu_torch/kernels/csrc/scan_apply.cu",
            replaces="fluidframework_tpu/mergetree/kernel.py:396",
            on_main_path=main_path and label == rule,
            launches=kernel_launches.get(f"{geo.path}[{variant}]", 0)
            if label == rule else 0,
            err=max_abs_err(run(), want), ms=ms_of(run, reps),
            plain_ms=plain_ms, library_ms=None,
            sms=min(b * geo.blocks, SM_COUNT), **work)
        r["device_ms"], r["device_ms_by"] = long_kernel_ms(run, PATH_REPS)
        require(r["err"] == 0, f"scan_apply {what} {label}: kernel vs "
                "plain differ")
        rows.append(r)
    bound = max(work["bytes"] / PEAK_BYTES_PER_S,
                work["ops"] / PEAK_OPS_PER_S) * 1e3
    every = max(work["bytes"] / PEAK_BYTES_PER_S,
                work["ops_every_slot"] / PEAK_OPS_PER_S) * 1e3
    print(f"  scan_apply[{variant}] {what} [{shape}]: bound {bound:.5f} ms "
          f"over the rows in use, {every:.5f} ms over every slot; plain "
          f"{plain_ms:.3f} ms; the rule takes {rule}; "
          f"{scan_input_facts(state, ops)}; card {card}", flush=True)
    for r in rows:
        sm_bound = max(work["bytes"] / PEAK_BYTES_PER_S, work["ops"] / (
            PEAK_OPS_PER_S * r["sms"] / SM_COUNT)) * 1e3
        print(f"    {r['path']} ({r['blocks']} block(s) x {r['threads']} "
              f"threads): {fmt_ms(r['device_ms'])} device "
              f"({r['device_ms_by']}), {r['ms']:.4f} ms back to back; "
              f"bound on its {r['sms']} SM(s) {sm_bound:.5f} ms",
              flush=True)
    dev_ms = {r["path"]: r["device_ms"] for r in rows}
    best = min(dev_ms.values())
    require(not main_path or dev_ms[rule] <= best * (1 + PATH_MARGIN),
            f"scan_apply at {shape}: the rule's {rule} path "
            f"({dev_ms[rule]:.4f} ms) is more than {PATH_MARGIN:.0%} slower "
            f"than the fastest path ({best:.4f} ms)")
    return rows


def catchup_split(catchup, kernel, tail, dev, captured, n_ops: int,
                  what: str, card: str) -> dict:
    """A timed catch-up run, the compaction's device time, then a profiled
    run (the longest trace of the script): wall, device busy and idle
    share, the scan kernels' device time, the host's ms by stage."""
    stats = {}
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    entries = catchup.device_apply_tail([], tail, 0, 0, device=dev,
                                        stats=stats)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - h0) * 1e3
    compact_ms = 0.0
    for c, n in stats["compacts"].items():
        st = captured[c][0]
        per = kernel_device_ms(lambda: kernel.compact(st), 3)
        compact_ms += n * sum(ms for ms, _n in per.values())
    trace = kernel_device_ms(lambda: catchup.device_apply_tail(
        [], tail, 0, 0, device=dev), 1)
    busy = sum(ms for ms, _n in trace.values()) if trace else None
    scan_ms = sum(ms for name, (ms, _n) in trace.items()
                  if "scan_apply_kernel" in name) if trace else None
    host = {k: round(v * 1e3, 3) for k, v in stats.items()
            if k.endswith("_s")}
    print(f"catch-up ({what}): {n_ops / (wall_ms / 1e3):.0f} ops/s, wall "
          f"{wall_ms:.3f} ms; chunks {stats['chunks']}, folds "
          f"{stats.get('folds', 0)}, retries {stats.get('retries', 0)}, "
          f"compacts {stats['compacts']}, host reads {stats['host_reads']}; "
          f"scan_apply kernels {fmt_ms(scan_ms)} device (profiler), "
          f"compact {compact_ms:.3f} ms device; host ms {host}; device busy "
          f"{fmt_ms(busy)} of the {wall_ms:.3f} ms wall (idle share "
          + (f"{1 - busy / wall_ms:.3f}" if busy else "not measured")
          + f"); card {card}", flush=True)
    return {"entries": entries, "wall_ms": wall_ms, "busy_ms": busy,
            "scan_ms": scan_ms}


def catchup_phases(dev, card: str):
    """Phase 11, the configuration at full size: keystroke_trace(100,000,
    seed=12) through mergetree/catchup.device_apply_tail on the card,
    every chunk on the scan-apply kernel and on the path scan_geometry
    names, held to the JAX golden digest; its first PLAIN_PREFIX ops also
    through the plain composition, entry by entry; every path timed at
    the first chunk of each capacity; a timed and a profiled run, then the
    same with every chunk forced onto global_chunked. Returns the scan
    kernel's rows, the catch-up's entries and its timed wall (ms)."""
    from fluidframework_tpu_torch.mergetree import catchup, kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import keystroke_trace

    g = golden.load_catchup()
    n_ops, seed, n_clients = g["full"]["trace"]
    tail = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)

    # The main path, counted: every apply launches the kernel once, on the
    # rule's path. The first chunk at each capacity is kept for the
    # timings below.
    captured, expected = {}, {}
    apply_keep = kernel.apply_ops_keep

    def capture(state, ops, runs=None):
        captured.setdefault(state.capacity, (
            type(state)(*(t.clone() for t in state)), ops, runs))
        geo = kernel.scan_geometry(1, state.capacity, state.overlap_slots,
                                   state.anno_slots)
        key = f"{geo.path}[{'plain' if runs is None else 'runs'}]"
        expected[key] = expected.get(key, 0) + 1
        return apply_keep(state, ops, runs)

    stats = {}
    kernel.apply_ops_keep = capture
    try:
        kernel.reset_launches()
        kernel.reset_zamboni_launches()
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        with PlainZamboniGuard() as zguard:
            entries = catchup.device_apply_tail([], tail, 0, 0, device=dev,
                                                stats=stats)
            torch.cuda.synchronize()
        first_ms = (time.perf_counter() - h0) * 1e3
        launches = kernel.scan_apply.launches
        by_kernel = {k: n for k, n in
                     kernel.scan_apply.kernel_launches.items() if n}
        folds = zamboni_counts()
    finally:
        kernel.apply_ops_keep = apply_keep
    applies = sum(stats["chunks"].values())
    require(launches > 0 and launches == applies,
            f"catch-up: {launches} scan_apply launches for {applies} chunk "
            "applies")
    compacts = sum(stats["compacts"].values())
    require(compacts > 0 and folds == {"compact": compacts,
                                       "compact_extract": 0, "extract": 0,
                                       "narrow_pack": 0},
            f"catch-up: zamboni.cu launches {folds} for {compacts} fold "
            "compactions")
    require(zguard.cuda_calls == 0, f"catch-up: the plain compaction ran "
            f"{zguard.cuda_calls} times on the card's tensors")
    require(by_kernel == expected,
            f"catch-up: launches by kernel {by_kernel}, the rule names "
            f"{expected}")
    digest = golden.entries_digest(entries)
    require(digest == g["full"]["digest"],
            f"catch-up of {n_ops} ops: {digest} differs from the JAX "
            f"golden {g['full']['digest']}")
    print(f"phase 11: catch-up of keystroke_trace({n_ops}, seed={seed}) "
          f"on the card equals the JAX golden (entries {digest['count']}, "
          f"visible length {digest['visible_length']}, entries and text "
          f"sha256); scan_apply launches {launches} by kernel {by_kernel}, "
          f"each on the rule's path; zamboni.cu launches {folds} (one a "
          f"fold compaction, none plain on the card); first run "
          f"{first_ms:.1f} ms", flush=True)
    small_n, small_seed, small_clients = g["small"]["trace"]
    small = catchup.device_apply_tail(
        [], keystroke_trace(small_n, seed=small_seed,
                            n_clients=small_clients), 0, 0, device=dev)
    require(small == g["small"]["entries"],
            f"catch-up of the {small_n}-op golden trace differs from JAX")

    head = tail[:PLAIN_PREFIX]
    got = catchup.device_apply_tail([], head, 0, 0, device=dev)
    want = catchup.device_apply_tail([], head, 0, 0, device=dev, plain=True)
    require(len(got) == len(want), f"first {PLAIN_PREFIX} ops: "
            f"{len(got)} entries vs {len(want)} in the plain composition")
    for i, (x, y) in enumerate(zip(got, want)):
        require(x == y, f"first {PLAIN_PREFIX} ops: entry {i} differs "
                f"from the plain composition: {x} vs {y}")
    print(f"phase 11: the first {PLAIN_PREFIX} ops equal the plain "
          f"composition entry by entry ({len(got)} entries)", flush=True)

    # every path's times at the catch-up's shapes (first chunk of each)
    rows = []
    for c in sorted(captured):
        state, ops, runs = captured[c]
        bs, bo = kernel._lift(state), kernel._lift(ops)
        br = kernel._lift(runs)
        rows += scan_rows("catch-up chunk", bs, bo, br, by_kernel, 3,
                          f"1 x C={c} x T {ops.steps}", card)
    # the C = 4,096 chunk with its annotate ring cut to one slot: the table
    # then fits one block (the smem path's row) and the fused apply takes
    # it too, which must agree
    if 4096 in captured:
        state, ops, runs = captured[4096]
        bs = kernel._lift(state)
        bs = bs._replace(anno=bs.anno[..., :1].contiguous())
        bo, br = kernel._lift(ops), kernel._lift(runs)
        require(4096 <= pa.max_fused_capacity(3, 1), "C=4096 > fused limit")
        fused_out = pa.apply_ops_fused(bs, bo, br)
        scan_out = kernel.scan_apply(bs, bo, br)
        torch.cuda.synchronize()
        assert_trees_equal(scan_out, fused_out, "C=4096 A=1 scan vs fused")
        f_dev = long_kernel_ms(lambda: pa.apply_ops_fused(bs, bo, br), 3)
        print(f"  C=4096 chunk at A=1: fused_apply {f_dev[0]:.4f} ms device "
              f"({f_dev[1]}; {pa.launch_geometry(1, 4096, 3, 1).path} "
              "path), equal to the scan apply", flush=True)
        rows += scan_rows("catch-up chunk at A=1", bs, bo, br, by_kernel, 3,
                          f"1 x C=4096 x T {ops.steps}, A=1", card,
                          main_path=False)

    new = catchup_split(catchup, kernel, tail, dev, captured, n_ops,
                        "the rule's paths", card)
    require(new["entries"] == entries, "catch-up: the timed run differs")
    rule = kernel.scan_geometry
    kernel.scan_geometry = lambda b, c, k, a: kernel._forced_geometry(
        "global_chunked", c, k, a)
    try:
        old = catchup_split(catchup, kernel, tail, dev, captured, n_ops,
                            "every chunk on global_chunked", card)
    finally:
        kernel.scan_geometry = rule
    require(old["entries"] == entries,
            "catch-up on global_chunked differs from the rule's paths")
    return rows, entries, new["wall_ms"]


def scan_full_step_phase(dev, card: str) -> list:
    """full_step above the fused capacity: SCAN_STEP documents x ops at
    capacity C through the scan-apply and summary-length kernels, counted,
    against the plain composition; returns the scan kernel's row."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree import pallas_ops
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing.traces import gen_traces

    b, t, c = SCAN_STEP
    require(c > pa.max_fused_capacity(3, 1), "SCAN_STEP fits the fused apply")
    ops = interop.packed_ops_from_numpy(gen_traces(b, t, seed=3), dev)
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)

    def fresh():
        return (tk.make_ticket_state(TICKET_K, b, device=dev),
                make_state(c, 1, batch=b, device=dev))

    kernel.reset_launches()
    pa.reset_launches()
    pallas_ops.summary_lengths.launches = 0
    tk.scan_tickets.launches = 0
    out = pipeline.full_step(*fresh(), raw, ops)
    torch.cuda.synchronize()
    by_kernel = {k: n for k, n in kernel.scan_apply.kernel_launches.items()
                 if n}
    launches = {"ticket_scan": tk.scan_tickets.launches,
                "scan_apply": kernel.scan_apply.launches,
                "summary_len": pallas_ops.summary_lengths.launches,
                "fused_apply": pa.apply_ops_fused.launches}
    require(launches == {"ticket_scan": 1, "scan_apply": 1,
                         "summary_len": 1, "fused_apply": 0},
            f"full_step at C={c}: launches {launches}")
    rule = kernel.scan_geometry(b, c, 3, 1)
    require(by_kernel == {f"{rule.path}[plain]": 1},
            f"full_step at C={c}: scan launches {by_kernel}, the rule names "
            f"{rule.path}")
    want = pipeline.make_full_step(plain=True)(*fresh(), raw, ops)
    torch.cuda.synchronize()
    assert_trees_equal(out, want, f"full_step {b}x{t} C={c} vs plain")
    require(not bool(out[1].overflow.any()), f"full_step C={c} overflowed")
    step_ms = once_ms(lambda: pipeline.full_step(*fresh(), raw, ops))
    print(f"phase 11: full_step {b}x{t} at C={c} (above the fused "
          f"capacity) through the kernels, launches {launches}, equal to "
          f"the plain composition; {b * t / (step_ms / 1e3):.0f} ops/s, "
          f"step {step_ms:.3f} ms; card {card}", flush=True)
    admitted = pipeline.admit_ops(ops, out[2])
    rows = scan_rows("full_step", fresh()[1], admitted, None, by_kernel, 2,
                     f"{b} x C={c} x T {t}", card)
    # the same ops on tables that fit one block (the smem path's row)
    return rows + scan_rows("full_step's ops", make_state(
        1024, 1, batch=b, device=dev), admitted, None, by_kernel, 2,
        f"{b} x C=1024 x T {t}", card, main_path=False)


class BusyWindow:
    """The device's busy milliseconds between start() and stop():
    torch.profiler's device time of every kernel, copy and memset it
    traced, read from the exported Chrome trace (key_averages() builds a
    Python event tree that takes minutes over a long window), except the
    scan-apply kernels, whose launches through ctypes the trace has
    missed: those are timed with a CUDA event pair around each launch
    (kernel._launch) in the window. stop() returns None when the
    profiler recorded nothing."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from fluidframework_tpu_torch.mergetree import kernel
        self._kernel, self._launch, self._pairs = kernel, kernel._launch, []
        launch, pairs = self._launch, self._pairs

        def timed(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = launch(*args, **kwargs)
            e1.record()
            pairs.append((e0, e1))
            return out

        torch.cuda.synchronize()
        kernel._launch = timed
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self):
        import tempfile
        try:
            torch.cuda.synchronize()
            self._prof.stop()
        finally:
            self._kernel._launch = self._launch
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        other = [e["dur"] / 1e3 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "scan_apply_kernel" not in e.get("name", "")]
        if not other and not self._pairs:
            return None
        return sum(other) + sum(a.elapsed_time(b) for a, b in self._pairs)


def device_busy_ms(fn):
    """Device busy milliseconds of one call of fn (BusyWindow)."""
    window = BusyWindow()
    window.start()
    try:
        fn()
    finally:
        busy = window.stop()
    return busy


def clone_state(st):
    return type(st)(*(t.clone() for t in st))


def paged_phase(dev, card: str) -> list:
    """Phase 12, a paged flush with hot documents: FULL_RING's partition
    plus HOT_RING's 64 documents pre-seeded to 3,500 live rows.
    (a) One megakernel ring: the small page groups on the fused apply,
    the hot group (C = 4,096, above max_fused_capacity) on the scan apply,
    counted per kernel, held to the plain composition, timed with a stage
    split. (b) A backlog staged as the JAX sequencer's
    MergeLaneStore._apply_paged stages it (testing/serving.
    stage_paged_groups), on every document but the ring's flagged ones
    (which the sequencer rolls back and rescues first): one
    apply_ops_paged per group of small documents,
    one serve_paged_burst for the hot documents' HOT_BACKLOG ops each (K =
    3 chunks at T = 256, padded to 4, C = 8,192), every output held to
    plain=True; the burst timed (events, device idle share); a
    rollback_pages round trip on a sub-plane of the hot group, then
    compact_pages over it. Returns the scan kernel's rows at the ring's
    hot-group window 0 and at the burst's first chunk, and (the store, the
    hot documents' keys) for phase 14."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree.oppack import PackedOps
    from fluidframework_tpu_torch.mergetree.paging import (PagedMergeStore,
                                                           pow2_pages)
    from fluidframework_tpu_torch.server import serve_step
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.server.lww_kernel import make_lww_state
    from fluidframework_tpu_torch.testing import serving

    fleet = serving.ServingFleet(getattr(serving, HOT_SPEC), seed=0)
    spec = fleet.spec
    store = PagedMergeStore(pages=HOT_POOL_PAGES, device=dev)
    limit = pa.max_fused_capacity(K_SLOTS, A_SLOTS)

    # -- (a) one ring: fused apply on the small groups, scan on the hot one
    t0 = time.perf_counter()
    staged = fleet.stage_ring(store)
    stage_s = time.perf_counter() - t0
    args = interop.ring_args_from_numpy(staged.args, dev)
    caps = [p.shape[1] * store.page_rows for p in staged.args.page_ids]
    hot = [g for g, c in enumerate(caps) if c > limit]
    require(len(hot) == 1, f"phase 12: page group capacities {caps}, "
            f"expected one above {limit}")
    hot_g = hot[0]
    ts0 = tk.make_ticket_state(serving.TICKET_CLIENTS, spec.docs,
                               device=dev)
    lww0 = [make_lww_state(spec.lww_capacity, fleet.lww_lanes, device=dev)]
    pool_pre = clone_state(store.pool)
    want = serve_step.make_serve_megakernel(keep=True, plain=True)(
        ts0, pool_pre, lww0, *args, stats=True)
    torch.cuda.synchronize()
    pa.reset_launches()
    kernel.reset_launches()
    tk.scan_tickets.launches = 0
    reset_window_counts()
    with PlainLwwGuard() as guard:
        got = serve_step.serve_megakernel(ts0, store.pool, lww0, *args,
                                          stats=True)
        torch.cuda.synchronize()
    require(tk.scan_tickets.launches == spec.windows,
            f"phase 12 ring: {tk.scan_tickets.launches} ticket_scan "
            f"launches for {spec.windows} windows")
    window_n = window_counts()
    require_window_launches("phase 12 ring", window_n, guard, spec.windows,
                            len(args.merge_xs), len(args.lww_xs))
    print(f"phase 12: the ring's window kernels launched {window_n} "
          f"({spec.windows} windows, {len(args.merge_xs)} groups, "
          f"{len(args.lww_xs)} LWW buckets); no plain LWW call on the "
          f"card's tensors", flush=True)
    fused_n = pa.apply_ops_fused.launches
    fused_by = {v: n for v, n in pa.apply_ops_fused.variant_launches.items()
                if n}
    ring_scan = {k: n for k, n in kernel.scan_apply.kernel_launches.items()
                 if n}
    assert_trees_equal(got, want, "phase 12 ring vs the plain composition")
    n_pad = staged.args.page_ids[hot_g].shape[0]
    geo = kernel.scan_geometry(n_pad, caps[hot_g], K_SLOTS, A_SLOTS)
    variant = "plain" if staged.args.runs_xs[hot_g] is None else "runs"
    require(ring_scan == {f"{geo.path}[{variant}]": spec.windows},
            f"phase 12 ring: scan launches {ring_scan}, expected "
            f"{spec.windows} on {geo.path}[{variant}]")
    require(fused_n == spec.windows * (len(caps) - 1),
            f"phase 12 ring: {fused_n} fused launches for "
            f"{len(caps) - 1} groups x {spec.windows} windows")
    layout = serve_step.flat16_layout(spec.docs, spec.steps,
                                      staged.merge_lanes, staged.lww_lanes,
                                      True, True)
    lo, _hi = layout["overflow"]
    over = got[3][-1, lo:lo + sum(staged.merge_lanes)].cpu().numpy()
    require(np.array_equal(over != 0,
                           np.concatenate(staged.expected_overflow)),
            "phase 12 ring: overflow lanes differ from the mispredicted "
            "runs")
    print(f"phase 12: ring of {spec.docs} documents ({staged.counts}), "
          f"groups {[tuple(p.shape) for p in staged.args.page_ids]} (C "
          f"{caps}; the hot group above max_fused_capacity {limit}), "
          f"staged in {stage_s:.2f} s; fused launches {fused_by}, scan "
          f"launches {ring_scan} ({geo}); equal to the plain composition",
          flush=True)
    trials = [ring_trial(serve_step.serve_megakernel, ts0, pool_pre, lww0,
                         args) for _ in range(TRIALS)]
    splits = [ring_trial(serve_step.serve_megakernel, ts0, pool_pre, lww0,
                         args, RING_SCAN_STAGES)[2] for _ in range(TRIALS)]
    ring_ms = float(np.median([t[0] for t in trials]))
    split = {k: round(float(np.median([x[k] for x in splits])), 3)
             for k in RING_SCAN_STAGES}
    n_ops = staged.counts["merge_ops"] + staged.counts["lww_ops"]
    print(f"phase 12 ring: {n_ops / (ring_ms / 1e3):.0f} ops/s, p50 "
          f"{ring_ms:.3f} ms (host clock p50 "
          f"{float(np.median([t[1] for t in trials])):.3f} ms, trials "
          f"{[round(t[0], 3) for t in trials]}), stage p50 ms {split}; "
          f"card {card}", flush=True)
    ring_view = got[5][hot_g]
    serving.adopt_ring(store, staged, got[3][-1].cpu().numpy(), stats=True)
    del want, trials, splits

    # -- (b) the backlog: apply_ops_paged per group, a burst for the hot one
    # The ring's flagged documents (its mispredicted runs) hold an
    # overflowed window's leftovers, values past their count included;
    # the sequencer rolls such a document back and rescues it on the host
    # (MergeLaneStore._recover_paged) before it applies anything more, so
    # the backlog skips them.
    flagged = {k for keys, over in zip(staged.keys, staged.expected_overflow)
               for k, o in zip(keys, over) if o}
    streams = {k: v for k, v in fleet.backlog(
        lambda cls: HOT_BACKLOG if cls.rows else cls.ops).items()
        if k not in flagged}
    groups = serving.stage_paged_groups(store, streams)
    bursts = [g for g in groups if g.burst]
    require(len(bursts) == 1 and bursts[0].ops["kind"].shape[0] == 4
            and bursts[0].page_ids.shape[1] * store.page_rows == 8192,
            f"phase 12 backlog: expected one 4-chunk burst at C = 8,192, "
            f"got {[(g.page_ids.shape, g.burst) for g in groups]}")

    def dispatch(pool, g, plain):
        dargs = [torch.from_numpy(x).to(dev) for x in (
            g.page_ids, g.counts, g.min_seqs, g.seqs)]
        ops = interop.packed_ops_from_numpy(g.ops, dev)
        fn = serve_step.serve_paged_burst if g.burst \
            else kernel.apply_ops_paged
        return fn(pool, *dargs, ops, stats=True, plain=plain)

    backlog_pre = clone_state(store.pool)
    ref_pool = clone_state(store.pool)
    refs = [dispatch(ref_pool, g, True) for g in groups]
    torch.cuda.synchronize()
    pa.reset_launches()
    kernel.reset_launches()
    outs = [dispatch(store.pool, g, False) for g in groups]
    torch.cuda.synchronize()
    backlog_scan = {k: n for k, n in kernel.scan_apply.kernel_launches.items()
                    if n}
    expect = {}
    for g in groups:
        b, p2 = g.page_ids.shape
        geo = kernel.scan_geometry(b, p2 * store.page_rows, K_SLOTS, A_SLOTS)
        key = f"{geo.path}[plain]"
        expect[key] = expect.get(key, 0) + (
            g.ops["kind"].shape[0] if g.burst else 1)
    require(backlog_scan == expect and pa.apply_ops_fused.launches == 0,
            f"phase 12 backlog: scan launches {backlog_scan}, expected "
            f"{expect}; fused launches {pa.apply_ops_fused.launches}")
    assert_trees_equal(store.pool, ref_pool, "phase 12 backlog pool")
    for g, out, ref in zip(groups, outs, refs):
        assert_trees_equal(out[1:], ref[1:], f"phase 12 backlog group "
                           f"{g.page_ids.shape}")
        require(not bool(out[5].any()), f"phase 12 backlog group "
                f"{g.page_ids.shape} overflowed")
    del ref_pool, refs
    print(f"phase 12: backlog of {sum(g.n_ops for g in groups)} ops ("
          f"{len(flagged)} flagged documents skipped) in "
          f"{len(groups)} page groups "
          f"{[(tuple(g.page_ids.shape), 'burst' if g.burst else 'apply') for g in groups]}"
          f", scan launches by kernel {backlog_scan}; every output equal "
          "to plain=True", flush=True)

    hb = bursts[0]
    hot_i = groups.index(hb)
    hot_out = outs[hot_i]
    bargs = [torch.from_numpy(x).to(dev) for x in (
        hb.page_ids, hb.counts, hb.min_seqs, hb.seqs)]
    bops = interop.packed_ops_from_numpy(hb.ops, dev)
    burst_ms = []
    for _ in range(TRIALS):
        pool = clone_state(backlog_pre)
        burst_ms.append(once_ms(lambda: serve_step.serve_paged_burst(
            pool, *bargs, bops)))
    pool = clone_state(backlog_pre)
    busy = device_busy_ms(lambda: serve_step.serve_paged_burst(
        pool, *bargs, bops))
    b_ms = float(np.median(burst_ms))
    print(f"phase 12 burst: {hb.n_ops} ops of {len(hb.keys)} hot documents"
          f" in {hb.ops['kind'].shape[0]} chunks of [{hb.page_ids.shape[0]}"
          f" x C={hb.page_ids.shape[1] * store.page_rows}] x T "
          f"{hb.ops['kind'].shape[-1]}: {hb.n_ops / (b_ms / 1e3):.0f} "
          f"ops/s, p50 {b_ms:.3f} ms (trials "
          f"{[round(x, 3) for x in burst_ms]}); device busy "
          f"{fmt_ms(busy)} (profiler, scan kernels by events; idle share "
          + (f"{1 - busy / b_ms:.3f}" if busy else "not measured")
          + f"); card {card}", flush=True)
    del pool, backlog_pre

    # rollback_pages round trip on the hot group's first two lanes
    sub = torch.arange(2, device=dev)
    sub_pids = bargs[0][sub]
    pre_sub = type(hot_out[7])(*(t[sub] for t in hot_out[7]))
    post_sub = kernel.gather_pages(store.pool, sub_pids, hot_out[2][sub],
                                   hot_out[3][sub], hot_out[4][sub])
    after_burst = clone_state(store.pool)
    want_back = kernel.rollback_pages_keep(store.pool, sub_pids, pre_sub)
    kernel.rollback_pages(store.pool, sub_pids, pre_sub)
    assert_trees_equal(store.pool, want_back, "phase 12 rollback_pages")
    back = kernel.gather_pages(store.pool, sub_pids, pre_sub.count,
                               pre_sub.min_seq, pre_sub.seq)
    assert_trees_equal(back, pre_sub, "phase 12 rolled-back rows")
    kernel.rollback_pages(store.pool, sub_pids, post_sub)
    assert_trees_equal(store.pool, after_burst, "phase 12 rollback round "
                       "trip")
    del after_burst, want_back
    for g, out in zip(groups, outs):
        serving.adopt_paged_group(store, g, out[2].cpu().numpy(),
                                  out[3].cpu().numpy(), out[4].cpu().numpy())

    # compact_pages over the hot group (its min_seq trails the removes)
    keys = hb.keys
    width = pow2_pages(max(len(store.tables[k]) for k in keys))
    cargs = [torch.from_numpy(x).to(dev) for x in
             (store.page_ids_array(keys, width),
              *store.scalars_arrays(keys))]
    want_c = kernel.compact_pages_keep(store.pool, *cargs)
    got_c = kernel.compact_pages(store.pool, *cargs)
    assert_trees_equal(got_c, want_c, "phase 12 compact_pages")
    before = int(cargs[1].sum())
    after = int(got_c[2].sum())
    require(after < before, "phase 12 compact_pages freed no row")
    pages = store.pages_in_use
    _counts, mins, seqs = store.scalars_arrays(keys)
    store.adopt_scalars(keys, got_c[2].cpu().numpy(), mins, seqs)
    store.release_trailing_many(keys)
    print(f"phase 12: rollback_pages round trip on 2 hot lanes exact; "
          f"compact_pages over the hot group: {before} -> {after} rows, "
          f"pages in use {pages} -> {store.pages_in_use}, fill "
          f"{store.page_fill_frac():.3f}; equal to compact_pages_keep",
          flush=True)

    # the scan kernel's rows at the new paths' inputs
    _ts, ticketed = tk.scan_tickets(
        ts0, tk.RawOps(client=args.ticket_xs[0, 1],
                       client_seq=args.ticket_xs[0, 2],
                       ref_seq=args.ticket_xs[0, 3],
                       kind=args.ticket_xs[0, 0]), require_join=True)
    ops0, runs0, _over = serve_step.admit_merge_ops(
        ticketed.seq, ticketed.min_seq, args.merge_xs[hot_g][0],
        None if args.runs_xs[hot_g] is None else args.runs_xs[hot_g][0])
    rows = scan_rows("phase 12 ring hot group, window 0", ring_view, ops0,
                     runs0, ring_scan, 3,
                     f"{ring_view.length.shape[0]} x C={caps[hot_g]} x Tm "
                     f"{ops0.steps}", card)
    chunk0 = PackedOps(*(col[0] for col in bops))
    rows += scan_rows("phase 12 burst, chunk 0", hot_out[7], chunk0, None,
                      backlog_scan, 3,
                      f"{hb.page_ids.shape[0]} x C="
                      f"{hb.page_ids.shape[1] * store.page_rows} x T "
                      f"{chunk0.steps}", card)
    return rows, (store, keys)


def scalar_cpu_main() -> int:
    """Phase 13's scalar replay in a process of its own: keystroke_trace
    (100,000, seed=12) op by op through the port's MergeTreeClient.
    apply_msg (a host path: the client's device serves apply_bulk only),
    in blocks of SCALAR_BLOCK ops until the whole trace or the block that
    crosses SCALAR_BUDGET_S; prints {"done", "seconds", "points" ((mean
    live segments, seconds an op) a block), "segments", "text_sha256"} as
    one JSON line."""
    import hashlib

    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import keystroke_trace
    torch.set_num_threads(1)
    n_ops, seed, n_clients = golden.load_catchup()["full"]["trace"]
    tail = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)
    client = MergeTreeClient(client_id=99, device="cpu")
    points, done = [], 0
    t0 = time.perf_counter()
    while done < n_ops and time.perf_counter() - t0 < SCALAR_BUDGET_S:
        block = tail[done:done + SCALAR_BLOCK]
        segs0 = len(client.tree.segments)
        b0 = time.perf_counter()
        for op, sq, ref, cl, msn in block:
            client.apply_msg(op, sq, ref, cl, min_seq=msn)
        dt = time.perf_counter() - b0
        points.append(((segs0 + len(client.tree.segments)) / 2,
                       dt / len(block)))
        done += len(block)
    print(json.dumps({
        "done": done, "seconds": time.perf_counter() - t0, "points": points,
        "segments": len(client.tree.segments),
        "text_sha256": hashlib.sha256(
            client.get_text().encode()).hexdigest()}), flush=True)
    return 0


def start_scalar_twin() -> subprocess.Popen:
    """scalar_cpu_main, started before the kernel build: the replay is
    host work alone, so it runs in the build's wall (beside nvcc, the
    set-up threads and phase 22's CPU twin) and phase 13 reads it. It is
    killed at exit if it is still running."""
    proc = subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "scalar_cpu_main())"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
    atexit.register(stop_twins, [proc])
    return proc


def scalar_phase(dev, card: str, catchup_entries,
                 twin: subprocess.Popen) -> None:
    """Phase 13, scalar against device catch-up: keystroke_trace(100,000,
    seed=12) replayed op by op through the port's MergeTreeClient.apply_msg
    on the host (the whole trace, or the prefix reached within
    SCALAR_BUDGET_S; scalar_cpu_main, in the process `twin`), its text
    equal to the device catch-up's (phase 11's for the whole trace); the
    scalar cost per op fitted against the live segments (least squares
    over blocks of SCALAR_BLOCK ops), the device wall fitted to the cost
    model's formula on prefixes of the same trace, and where
    mergetree/costmodel.device_bulk_wins puts the crossover, by the fit
    and by the committed constants."""
    import hashlib

    from fluidframework_tpu_torch.mergetree import catchup, costmodel
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import keystroke_trace

    n_ops, seed, n_clients = golden.load_catchup()["full"]["trace"]
    tail = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)
    t0 = time.perf_counter()
    text, _ = twin.communicate(timeout=SCALAR_BUDGET_S * 4)
    waited_s = time.perf_counter() - t0
    require(twin.returncode == 0,
            f"phase 13: the scalar replay's process exited {twin.returncode}")
    replay = json.loads(text.strip().splitlines()[-1])
    done, scalar_s = replay["done"], replay["seconds"]
    points = [tuple(p) for p in replay["points"]]
    if done == n_ops:
        want_text = golden.entries_text(catchup_entries)
        device_s = None
    else:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        entries = catchup.device_apply_tail([], tail[:done], 0, 0,
                                            device=dev)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - h0
        want_text = golden.entries_text(entries)
    require(replay["text_sha256"]
            == hashlib.sha256(want_text.encode()).hexdigest(),
            f"phase 13: the scalar replay of {done} ops differs from the "
            "device catch-up's text")
    segs = np.asarray([p[0] for p in points])
    per_op = np.asarray([p[1] for p in points])
    base, per_seg = np.linalg.lstsq(
        np.stack([np.ones_like(segs), segs], 1), per_op, rcond=None)[0]
    how = "least squares"
    if base < 0:   # keep the model's scalar cost positive at 0 segments
        base, per_seg = 0.0, float((segs @ per_op) / (segs @ segs))
        how = "least squares through the origin (the free fit's base < 0)"
    print(f"phase 13: scalar replay of {done} of {n_ops} ops "
          f"(keystroke_trace seed {seed}) through MergeTreeClient.apply_msg "
          f"in a process of its own beside the kernel build (phase 13 "
          f"waited {waited_s:.1f} s for it): {scalar_s * 1e3:.1f} ms "
          f"({done / scalar_s:.0f} ops/s), text equal to the device "
          f"catch-up's; live segments {int(segs[0])} -> "
          f"{replay['segments']}; (live segments, us per op) by block of "
          f"{SCALAR_BLOCK} ops "
          f"{[(int(x), round(y * 1e6, 1)) for x, y in points]}",
          flush=True)

    # the device side: the catch-up's wall on prefixes of the same trace
    catchup.device_apply_tail([], tail[:DEVICE_PREFIXES[0]], 0, 0,
                              device=dev)
    walls = []
    for n in DEVICE_PREFIXES + (n_ops,):
        runs = []
        for _ in range(1 if n == n_ops else 3):
            stats = {}
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            catchup.device_apply_tail([], tail[:n], 0, 0, device=dev,
                                      stats=stats)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - h0)
        walls.append((n, float(np.median(runs)),
                      sum(stats["chunks"].values())))
    chunk_t = catchup.CHUNK_T
    a = np.asarray([[-(-n // chunk_t), n] for n, _w, _c in walls], float)
    w = np.asarray([wall for _n, wall, _c in walls])
    # relative least squares: every prefix weighs alike
    chunk_s, op_s = np.linalg.lstsq(a / w[:, None], np.ones_like(w),
                                    rcond=None)[0]
    if chunk_s < 0:   # keep the floor per chunk non-negative
        chunk_s, op_s = 0.0, float(np.mean(w / a[:, 1]))
    print(f"phase 13: device catch-up wall by prefix (ops, ms, chunks "
          f"applied): {[(n, round(x * 1e3, 3), c) for n, x, c in walls]}; "
          f"fit wall = ceil(ops / {chunk_t}) x {chunk_s * 1e3:.4f} ms + ops "
          f"x {op_s * 1e6:.4f} us (fitted walls "
          f"{[round(float(v) * 1e3, 3) for v in a @ [chunk_s, op_s]]} ms);"
          f" card {card}", flush=True)
    print(f"phase 13: costmodel fit (chip_smoke.py phase 13, this run): "
          f"SCALAR_BASE_S = {base:.4g}, SCALAR_PER_SEG_S = {per_seg:.4g} "
          f"({how}), DEVICE_CHUNK_S = {chunk_s:.4g}, DEVICE_PER_OP_S = "
          f"{op_s:.4g}; committed: SCALAR_BASE_S = "
          f"{costmodel.SCALAR_BASE_S:.4g}, SCALAR_PER_SEG_S = "
          f"{costmodel.SCALAR_PER_SEG_S:.4g}, DEVICE_CHUNK_S = "
          f"{costmodel.DEVICE_CHUNK_S:.4g}, DEVICE_PER_OP_S = "
          f"{costmodel.DEVICE_PER_OP_S:.4g}", flush=True)
    if device_s is not None:
        print(f"phase 13: at the same {done}-op prefix the device catch-up "
              f"took {device_s * 1e3:.1f} ms against the scalar replay's "
              f"{scalar_s * 1e3:.1f} ms", flush=True)

    def wins(n, live, consts):
        sb, ss, dc, do = consts
        dev_s = -(-n // chunk_t) * dc + n * do
        return n * (sb + ss * live) > dev_s * costmodel.HYSTERESIS

    fitted = (base, per_seg, chunk_s, op_s)
    committed = (costmodel.SCALAR_BASE_S, costmodel.SCALAR_PER_SEG_S,
                 costmodel.DEVICE_CHUNK_S, costmodel.DEVICE_PER_OP_S)
    for name, consts in (("fit", fitted), ("committed", committed)):
        cross = {}
        for live in CROSSOVER_SEGMENTS:
            n = 1
            while n <= 2**20 and not wins(n, live, consts):
                n *= 2
            cross[live] = n if n <= 2**20 else None
        print(f"phase 13: crossover by the {name} constants (smallest "
              f"power-of-two tail that routes to the device, by live "
              f"segments; None = never up to 2^20 ops): {cross}",
              flush=True)
    if os.environ.get("FLUID_TPU_FORCE_BULK") is None:
        for live in CROSSOVER_SEGMENTS:
            for n in (64, 4096, 2**20):
                require(costmodel.device_bulk_wins(n, live, backend="cuda")
                        == wins(n, live, committed),
                        "phase 13: device_bulk_wins differs from its "
                        "formula")



def assert_arrays_equal(got, want, what: str) -> None:
    """Two tuples of host numpy arrays: equal dtype, shape and values."""
    require(len(got) == len(want), f"{what}: length")
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{what}[{i}]: dtype/shape {g.dtype}{g.shape} vs "
                f"{w.dtype}{w.shape}")
        if not np.array_equal(g, w):
            raise SmokeFailure(f"{what}[{i}]: differs in "
                               f"{int((g != w).sum())} elements")


def live_rows_equal(a, b, what: str) -> None:
    """Two fetched extractions agree on every document's live rows."""
    counts = a[-1]
    require(np.array_equal(counts, b[-1]), f"{what}: counts differ")
    live = np.arange(a[0].shape[1])[None, :] < counts[:, None]
    for i, (x, y) in enumerate(zip(a[:-1], b[:-1])):
        require(np.array_equal(x[live], y[live]),
                f"{what}: column {i} differs on live rows")


def fetch_counted(kernel, packed, narrow: bool):
    """kernel.fetch_extracted and its (bytes, refetched documents)."""
    from fluidframework_tpu_torch.telemetry import counters
    b0 = counters.get("summarize.bytes_d2h")
    r0 = counters.get("summarize.wire_refetch")
    out = kernel.fetch_extracted(packed, narrow=narrow)
    return out, (int(counters.get("summarize.bytes_d2h") - b0),
                 int(counters.get("summarize.wire_refetch") - r0))


def host_and_device_ms(fn):
    """(host p50, device p50, host trials) in ms of fn over TRIALS warm
    calls, each between two syncs (bench.py's host clock around a synced
    call) and two CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(TRIALS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - h0) * 1e3)
        device.append(e0.elapsed_time(e1))
    return float(np.median(host)), float(np.median(device)), host


def extract_golden_check(dev) -> None:
    """The card against the JAX package's outputs on the extraction
    golden's batch (testing/golden.py): compact_extract_batched(stats=True),
    both fetches with their counter deltas, two documents' snapshots, and
    the catch-up blob of the small golden entries."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import catchup, host, kernel
    from fluidframework_tpu_torch.mergetree.runs import encode_entry_payloads
    from fluidframework_tpu_torch.testing import golden

    g = golden.load_extract()
    state = interop.doc_state_from_numpy(g["state_in"], dev)
    comp, packed, pre = kernel.compact_extract_batched(state, stats=True)
    torch.cuda.synchronize()
    assert_matches_numpy(comp, g["compacted"], "golden compacted state")
    assert_arrays_equal(tuple(t.cpu().numpy() for t in packed),
                        tuple(g["packed"][f] for f in golden.PACKED_FIELDS),
                        "golden packed rows")
    assert_arrays_equal((pre.cpu().numpy(),), (g["pre_counts"]["count"],),
                        "golden pre-compaction counts")
    fetched = {}
    for form, narrow in (("narrow", True), ("wide", False)):
        fetched[form], (nbytes, refetch) = fetch_counted(kernel, packed,
                                                         narrow)
        assert_arrays_equal(fetched[form], tuple(
            g[form][f] for f in golden.PACKED_FIELDS), f"golden {form}")
        require(nbytes == int(g["wire"][f"{form}_bytes"]),
                f"golden {form} fetch: {nbytes} bytes, JAX "
                f"{int(g['wire'][f'{form}_bytes'])}")
        if narrow:
            require(refetch == int(g["wire"]["refetch"]),
                    f"golden narrow fetch refetched {refetch} documents")
    doc = g["json"]
    for d, want in doc["snapshots"].items():
        snap = host.assemble_snapshot(
            fetched["narrow"], doc["payloads"], d,
            min_seq=int(g["state_in"]["min_seq"][d]),
            seq=int(g["state_in"]["seq"][d]))
        require(json.loads(json.dumps(snap)) == want,
                f"golden snapshot of document {d} differs from JAX")
    small = encode_entry_payloads(golden.load_catchup()["small"]["entries"])
    blob = catchup.pack_entries_narrow(small, doc["catchup_base"])
    require(json.loads(json.dumps(blob)) == doc["catchup_blob"],
            "golden catch-up blob differs from JAX")
    print(f"phase 14: the extraction golden ({g['state_in']['count'].size} "
          f"documents, one refetched) equals the JAX outputs: compacted "
          f"state, packed rows, pre-compaction counts, both fetches and "
          f"their bytes, {len(doc['snapshots'])} snapshots, the catch-up "
          "blob", flush=True)


def summarize_phase(dev, card: str, hot, catchup_entries) -> list:
    """Phase 14, the summarize path at the north-star size (bench.py
    summarize). Counted run: full_step from fresh state (fused apply and
    summary length), then (1) extract_visible_batched -> fetch_extracted
    both forms; (2) the 1%-dirty pass: gather_rows_pow2 ->
    compact_extract_batched(stats=True) -> fetch_extracted ->
    assemble_snapshot of each dirty document -> device_stats.fold_extract;
    (3) compact_extract_paged(_keep) over phase 12's hot documents; (4) the
    100,000-op catch-up again (scan apply) -> pack_entries_narrow ->
    unpack_entries_narrow and translate_entry_clients. Every output held to
    the same function on CPU copies of its inputs (the paged form to
    compact_pages + extraction of the gathered view), the narrow fetch to
    the wide one; then the JAX golden; then the timings."""
    from fluidframework_tpu_torch import interop, kernels
    from fluidframework_tpu_torch.mergetree import (catchup, host, kernel,
                                                    pallas_apply, pallas_ops)
    from fluidframework_tpu_torch.mergetree.paging import pow2_pages
    from fluidframework_tpu_torch.mergetree.runs import encode_entry_payloads
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.telemetry import counters, device_stats
    from fluidframework_tpu_torch.telemetry.compile_ledger import ledger
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import (fuzz_tables,
                                                         gen_traces,
                                                         gen_traces_payloads,
                                                         keystroke_trace)

    store, hot_keys = hot
    cols = gen_traces(DOCS, OPS, seed=0)
    ops = interop.packed_ops_from_numpy(cols, dev)
    raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                    ref_seq=ops.ref_seq)
    payloads = gen_traces_payloads(OPS)
    dirty = np.arange(0, DOCS, DIRTY_STRIDE, dtype=np.int32)
    trace = golden.load_catchup()["full"]["trace"]
    tail = keystroke_trace(trace[0], seed=trace[1], n_clients=trace[2])
    width = pow2_pages(max(len(store.tables[k]) for k in hot_keys))
    p_args = [torch.from_numpy(x).to(dev) for x in (
        store.page_ids_array(hot_keys, width),
        *store.scalars_arrays(hot_keys))]
    paged_pre = clone_state(store.pool)

    def dirty_pass(state):
        sub, n = kernel.gather_rows_pow2(state, dirty)
        comp, packed, pre = kernel.compact_extract_batched(sub, stats=True)
        return sub, n, comp, packed, pre

    # -- the counted run ---------------------------------------------------
    wrappers = (kernels.selftest, tk.scan_tickets,
                pallas_ops.summary_lengths, pallas_apply.apply_ops_fused)
    for fn in wrappers:
        fn.launches = 0
    pallas_apply.reset_launches()
    kernel.reset_launches()
    kernel.reset_zamboni_launches()
    with PlainZamboniGuard() as zguard:
        _tout, mout, _tkd, _total = pipeline.full_step(
            tk.make_ticket_state(TICKET_K, DOCS, device=dev),
            make_state(CAPACITY, ANNO, batch=DOCS, device=dev), raw, ops)
        full_packed = kernel.extract_visible_batched(mout)
        narrow, (n_bytes, n_refetch) = fetch_counted(kernel, full_packed,
                                                     True)
        wide, (w_bytes, _) = fetch_counted(kernel, full_packed, False)
        sub, n_dirty, d_comp, d_packed, d_pre = dirty_pass(mout)
        d_fetched, (d_bytes, _) = fetch_counted(kernel, d_packed, True)
        t0 = time.perf_counter()
        snaps = [host.assemble_snapshot(
            d_fetched, payloads, j, min_seq=int(sub.min_seq[j]),
            seq=int(sub.seq[j])) for j in range(n_dirty)]
        assemble_ms = (time.perf_counter() - t0) * 1e3
        pre_np = d_pre.cpu().numpy()[:n_dirty]
        post_np = d_fetched[-1][:n_dirty]
        extract0 = {k: counters.get(f"device.extract.{k}")
                    for k in device_stats.EXTRACT_SLOTS}
        device_stats.fold_extract([n_dirty, int(post_np.sum()),
                                   int((pre_np.astype(np.int64)
                                        - post_np).sum())])
        p_keep = kernel.compact_extract_paged_keep(store.pool, *p_args)
        p_out = kernel.compact_extract_paged(store.pool, *p_args)
        entries = catchup.device_apply_tail([], tail, 0, 0, device=dev)
        torch.cuda.synchronize()
    launches = {"selftest": kernels.selftest.launches,
                "ticket_scan": tk.scan_tickets.launches,
                "summary_len": pallas_ops.summary_lengths.launches,
                "fused_apply": pallas_apply.apply_ops_fused.launches,
                "scan_apply": kernel.scan_apply.launches}
    z_counts = zamboni_counts()
    launches.update({f"zamboni[{m}]": z_counts[m]
                     for m in kernel.ZAMBONI_MODES})
    launches["narrow_pack"] = z_counts["narrow_pack"]
    require(all(n > 0 for k, n in launches.items() if k != "selftest"),
            f"phase 14: the summarize path did not launch every kernel: "
            f"{launches}")
    require(zguard.cuda_calls == 0, f"phase 14: the plain compaction, "
            f"extraction or narrow pack ran {zguard.cuda_calls} times on "
            f"the card's tensors")
    print(f"phase 14: the summarize path's counted run launched {launches}",
          flush=True)

    # -- (1) full extraction: card vs CPU copies, narrow vs wide -----------
    m_cpu = type(mout)(*(t.cpu() for t in mout))
    cpu_packed = kernel.extract_visible_batched(m_cpu)
    assert_arrays_equal(tuple(t.cpu().numpy() for t in full_packed),
                        tuple(t.numpy() for t in cpu_packed),
                        "full extraction vs CPU")
    c_narrow, c_n = fetch_counted(kernel, cpu_packed, True)
    c_wide, c_w = fetch_counted(kernel, cpu_packed, False)
    assert_arrays_equal(narrow, c_narrow, "narrow fetch vs CPU")
    assert_arrays_equal(wide, c_wide, "wide fetch vs CPU")
    require((n_bytes, n_refetch) == c_n and w_bytes == c_w[0],
            f"fetch bytes {n_bytes}/{w_bytes} vs CPU {c_n}/{c_w}")
    live_rows_equal(narrow, wide, "narrow vs wide fetch")
    drop = 1 - n_bytes / w_bytes
    require(drop >= NARROW_MIN_DROP, f"narrow wire drops {drop:.3f} of the "
            f"wide bytes ({n_bytes} vs {w_bytes}), under {NARROW_MIN_DROP}")
    live = int(narrow[-1].sum())
    print(f"phase 14 (1): extraction of {DOCS} documents equals the CPU "
          f"composition; narrow fetch equals the wide one on {live} live "
          f"rows; bytes narrow {n_bytes}, wide {w_bytes} (drop {drop:.4f}), "
          f"{n_refetch} documents refetched", flush=True)

    # -- (2) the 1%-dirty pass ---------------------------------------------
    c_sub, c_n_dirty, c_comp, c_dpacked, c_pre = dirty_pass(m_cpu)
    require(n_dirty == c_n_dirty == len(dirty), "dirty count")
    assert_trees_equal(tuple(t.cpu() for t in sub), tuple(c_sub),
                       "dirty gather vs CPU")
    assert_trees_equal(tuple(t.cpu() for t in d_comp), tuple(c_comp),
                       "dirty compacted state vs CPU")
    assert_trees_equal(tuple(t.cpu() for t in d_packed), tuple(c_dpacked),
                       "dirty packed rows vs CPU")
    assert_trees_equal(d_pre.cpu(), c_pre, "dirty stats plane vs CPU")
    c_fetched, c_d = fetch_counted(kernel, c_dpacked, True)
    assert_arrays_equal(d_fetched, c_fetched, "dirty fetch vs CPU")
    require(d_bytes == c_d[0], f"dirty fetch bytes {d_bytes} vs {c_d[0]}")
    c_snaps = [host.assemble_snapshot(
        c_fetched, payloads, j, min_seq=int(c_sub.min_seq[j]),
        seq=int(c_sub.seq[j])) for j in range(n_dirty)]
    require(snaps == c_snaps, "dirty snapshots differ from the CPU's")
    for j, d in enumerate(dirty[:3]):   # and from the full pass's rows
        require(snaps[j] == host.assemble_snapshot(
            narrow, payloads, int(d), min_seq=int(m_cpu.min_seq[d]),
            seq=int(m_cpu.seq[d])), f"dirty snapshot of document {d} "
            "differs from the full pass's")
    ext = {k: counters.get(f"device.extract.{k}") - extract0[k]
           for k in device_stats.EXTRACT_SLOTS}
    require(ext["docs"] == n_dirty and ext["rows_live"] == post_np.sum(),
            f"device.extract counters {ext}")
    print(f"phase 14 (2): dirty pass over {n_dirty} documents (pow2 "
          f"{sub.length.shape[0]}) equals the CPU composition (gather, "
          f"compaction, packed rows, stats plane, fetch, snapshots); "
          f"device.extract deltas {ext}; {d_bytes} bytes; assembly of "
          f"{n_dirty} snapshots {assemble_ms:.3f} ms host, "
          f"{sum(s['header']['totalLength'] for s in snaps)} characters",
          flush=True)

    # -- (3) the paged form --------------------------------------------------
    ref_pool, _pids, ref_counts = kernel.compact_pages_keep(paged_pre,
                                                            *p_args)
    view = kernel.gather_pages(ref_pool, p_args[0], ref_counts, p_args[2],
                               p_args[3])
    want_packed = kernel.extract_visible_batched(view)
    for name, out in (("compact_extract_paged_keep", p_keep),
                      ("compact_extract_paged", p_out)):
        assert_trees_equal(out[0], ref_pool, f"{name} pool")
        assert_trees_equal(out[2], ref_counts, f"{name} counts")
        assert_trees_equal(tuple(out[3]), tuple(want_packed),
                           f"{name} packed rows vs compact_pages + extract")
    require(p_out[0] is store.pool, "compact_extract_paged not in place")
    paged_live = int(ref_counts.sum())
    print(f"phase 14 (3): compact_extract_paged(_keep) over {len(hot_keys)} "
          f"hot documents [{p_args[0].shape[0]} x "
          f"{p_args[0].shape[1] * store.page_rows}] equals compact_pages + "
          f"extract_visible_batched ({int(p_args[1].sum())} -> {paged_live} "
          "rows)", flush=True)

    # -- (4) the read-path wire --------------------------------------------
    require(entries == catchup_entries,
            "phase 14 catch-up entries differ from phase 11's")
    wire_entries = encode_entry_payloads(entries)
    base = max(max(e.get("seq", 0), e.get("removedSeq", 0))
               for e in wire_entries)
    t0 = time.perf_counter()
    blob = catchup.pack_entries_narrow(wire_entries, base)
    pack_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = catchup.unpack_entries_narrow(blob)
    unpack_ms = (time.perf_counter() - t0) * 1e3
    require(back == wire_entries, "catch-up blob does not round-trip")
    blob_bytes = len(json.dumps(blob))
    json_bytes = len(json.dumps(wire_entries))
    clients = sorted({e[f] for e in wire_entries
                      for f in ("client", "removedClient") if f in e})
    mapping = {c: 100 + c for c in clients}
    moved = catchup.translate_entry_clients(wire_entries, mapping)
    require(all(m.get(f) == mapping[e[f]] for e, m in zip(wire_entries,
                                                          moved)
                for f in ("client", "removedClient") if f in e),
            "translate_entry_clients")
    print(f"phase 14 (4): catch-up wire of {len(entries)} entries (base "
          f"{base}): blob {blob_bytes} bytes vs json.dumps {json_bytes} "
          f"({blob_bytes / json_bytes:.4f}); pack {pack_ms:.3f} ms, unpack "
          f"{unpack_ms:.3f} ms host; round trip exact; clients {clients} "
          "translated", flush=True)

    extract_golden_check(dev)

    # -- timings -------------------------------------------------------------
    # Host clock around the whole call (bench.py's method); CUDA events
    # around the device half alone (extraction + narrow pack, no copy).
    full_host, _ev, full_trials = host_and_device_ms(
        lambda: kernel.fetch_extracted(kernel.extract_visible_batched(mout)))
    dirty_host, _ev, dirty_trials = host_and_device_ms(
        lambda: kernel.fetch_extracted(dirty_pass(mout)[3]))
    mx = narrow[0].shape[1]
    _h, full_dev, _t = host_and_device_ms(lambda: kernel.narrow_pack(
        kernel.extract_visible_batched(mout), mx))
    _h, fused_dev, _t = host_and_device_ms(lambda: kernel.narrow_pack(
        kernel.compact_extract_batched(mout)[1], mx))
    _h, dirty_dev, _t = host_and_device_ms(lambda: kernel.narrow_pack(
        dirty_pass(mout)[3], d_fetched[0].shape[1]))
    paged_ms = float(np.median([once_ms(
        lambda: kernel.compact_extract_paged(store.pool, *p_args))
        for _ in range(TRIALS)]))
    # Bounds: each input plane read once, each output written once. The
    # extraction reads 7 + A planes (rem_clients' first slot only) and
    # count / min_seq and writes the narrow wire; the fused zamboni also
    # reads and writes every plane of the state (8 + K + A).
    plane = DOCS * CAPACITY * 4
    k, a = mout.overlap_slots, mout.anno_slots
    wire = n_bytes - 4 * DOCS
    full_bound = ((7 + a) * plane + 8 * DOCS + wire) / PEAK_BYTES_PER_S * 1e3
    fused_bound = (2 * (8 + k + a) * plane + 16 * DOCS + wire) \
        / PEAK_BYTES_PER_S * 1e3
    print(f"phase 14 timings: full extraction (extract_visible_batched + "
          f"narrow fetch, {DOCS} documents) p50 {full_host:.3f} ms host "
          f"clock (trials {[round(x, 3) for x in full_trials]}); its device "
          f"half (extraction + narrow pack at mx {mx}) {full_dev:.4f} ms "
          f"events, bound {full_bound:.4f} ms; the fused zamboni + "
          f"extraction + narrow pack {fused_dev:.4f} ms events, bound "
          f"{fused_bound:.4f} ms (bytes over 3.35 TB/s); dirty 1% "
          f"(gather_rows_pow2 + compact_extract_batched + narrow fetch, "
          f"{n_dirty} documents) p50 {dirty_host:.3f} ms host (trials "
          f"{[round(x, 3) for x in dirty_trials]}), device half "
          f"{dirty_dev:.4f} ms events; speedup {full_host / dirty_host:.2f}x"
          f" (bench.py summarize-smoke asks >= 5x; recorded, not gated); "
          f"compact_extract_paged p50 {paged_ms:.4f} ms (events, in place); "
          f"card {card}", flush=True)
    gather = {k: counters.get(f"kernel.extract_gather.{k}")
              for k in ("compiles", "retraces")}
    print(f"phase 14: kernel.extract_gather {gather}; device.extract "
          f"{device_stats.snapshot()}; compile ledger "
          f"{json.dumps(ledger.bench_stamp(), sort_keys=True)}", flush=True)

    # -- the zamboni and narrow-pack kernels' rows ----------------------------
    lanes_n, lane_c = LANE_BUCKET0
    tab = fuzz_tables(lanes_n, lane_c, K_SLOTS, A_SLOTS, seed=20,
                      free=lane_c // 4)
    tab["min_seq"] = np.random.default_rng(20).integers(
        0, 9, lanes_n).astype(np.int32)
    fold = fuzz_tables(2, FOLD_C, 3, ANNO, seed=21, free=64)
    fold = {f: v[1:] for f, v in fold.items()}
    fold["min_seq"] = np.full(1, 4, np.int32)
    shapes = {
        f"north-star state [{DOCS} x C {CAPACITY}], A {ANNO}": mout,
        f"lane store bucket 0 [{lanes_n} x C {lane_c}], A {A_SLOTS}":
            interop.doc_state_from_numpy(tab, dev),
        f"phase 14 (3) paged view [{p_args[0].shape[0]} x C "
        f"{p_args[0].shape[1] * store.page_rows}], A "
        f"{paged_pre.anno_slots}": kernel.gather_pages(paged_pre, *p_args),
        f"catch-up fold [1 x C {FOLD_C}], A {ANNO}":
            interop.doc_state_from_numpy(fold, dev)}
    t0 = time.perf_counter()
    rows = zamboni_rows(card, shapes, z_counts)
    print(f"phase 14: the zamboni and narrow-pack rows took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def zamboni_rows(card: str, shapes: dict, counts: dict) -> list:
    """Rows of zamboni.cu (each mode) and narrow_pack.cu (on the fused
    mode's packed rows, at the width fetch_extracted picks) at `shapes`
    ({label: a [B, C] state on the card}): each held bit-exact to its
    plain version on CPU copies of its inputs, timed back to back, by the
    profiler and, for the plain version, on the card's tensors, and
    printed beside its bound. The bound counts the bytes this data needs:
    count and min_seq, rem_seq of each live row (index below min(count,
    C)), the other planes of each kept row (8 + K + A ints compacting, 7 +
    A extracting, and the last row of a document with padding), and every
    output written once; the narrow pack reads mx slots of 7 + A planes
    and writes the wire. `counts` are phase 14's counted-run launches."""
    from fluidframework_tpu_torch.mergetree import kernel
    modes = {
        "compact": (kernel.compact_batched, kernel.compact_batched_plain),
        "compact_extract": (
            lambda s: kernel.compact_extract_batched(s, stats=True),
            lambda s: kernel.compact_extract_batched_plain(s, stats=True)),
        "extract": (kernel.extract_visible_batched,
                    kernel.extract_visible_batched_plain)}
    rows = []
    for label, st in shapes.items():
        cpu = type(st)(*(x.cpu() for x in st))
        b, c = st.length.shape
        k, a = st.overlap_slots, st.anno_slots
        scanned = int(cpu.count.clamp(0, c).sum())
        outs = {}
        for mode, (fn, plain) in modes.items():
            got, want = fn(st), plain(cpu)
            torch.cuda.synchronize()
            outs[mode] = (got, want)
        kept_doc = outs["compact"][1].count
        kept = int(kept_doc.sum())
        padded = int((kept_doc < c).sum())
        head = 8 * b + 4 * scanned
        nbytes = {
            "compact": head + 4 * kept * (7 + k + a)
            + 4 * b * c * (8 + k + a) + 4 * b,
            "compact_extract": head + 4 * kept * (7 + k + a)
            + 4 * b * c * (9 + k + a) + 8 * b,
            "extract": head + 4 * kept * (6 + a) + 4 * padded * (7 + a)
            + 4 * b * c * (7 + a) + 4 * b}
        packed = outs["compact_extract"][0][1]
        cpu_packed = outs["compact_extract"][1][1]
        mx = min((max(int(cpu_packed[-1].max()), 1) + 31) // 32 * 32, c)
        outs["narrow_pack"] = (kernel.narrow_pack(packed, mx),
                               kernel.narrow_pack_plain(cpu_packed, mx))
        torch.cuda.synchronize()
        nbytes["narrow_pack"] = 4 * b * mx * (7 + a) + 4 * b \
            + 2 * b * mx * (6 + a) + 4 * b * mx + 16 * b
        n_ops = {m: scanned for m in modes}
        n_ops["narrow_pack"] = 4 * b * mx * (7 + a)
        calls = {m: (lambda fn=fn: fn(st)) for m, (fn, _p) in modes.items()}
        calls["narrow_pack"] = lambda: kernel.narrow_pack(packed, mx)
        plains = {m: (lambda p=p: p(st)) for m, (_f, p) in modes.items()}
        plains["narrow_pack"] = lambda: kernel.narrow_pack_plain(packed, mx)
        trace = kernel_device_ms(lambda: [f() for f in calls.values()], 10)
        for i, mode in enumerate(calls):
            got, want = outs[mode]
            g = [x.cpu() for x in flat_tree(got)]
            w = flat_tree(want)
            require(len(g) == len(w) and all(
                x.dtype == y.dtype and x.shape == y.shape
                for x, y in zip(g, w)), f"{mode} {label}: the kernel's "
                "outputs differ in dtype or shape from the plain version's")
            err = max_abs_err(g, w)
            name = "narrow_pack" if mode == "narrow_pack" else "zamboni"
            ident = ZAMBONI_KERNELS[i]
            mangled = ident.replace("<", "ILi").replace(">", "E")
            hits = [(ms, n) for key, (ms, n) in trace.items()
                    if ident in key or mangled in key]
            dev_ms = sum(ms for ms, _n in hits) / sum(n for _ms, n in hits) \
                if hits else None
            r = dict(name=name,
                     variant="wire" if name == "narrow_pack" else mode,
                     source=NARROW_SOURCE if name == "narrow_pack"
                     else ZAMBONI_SOURCE,
                     replaces=ZAMBONI_REPLACES[mode], on_main_path=True,
                     launches=counts[mode], err=err,
                     ms=ms_of(calls[mode], 10), device_ms=dev_ms,
                     plain_ms=ms_of(plains[mode], 1), library_ms=None,
                     shape=label + (f", mx {mx}" if name == "narrow_pack"
                                    else ""),
                     bytes=nbytes[mode], ops=n_ops[mode])
            bound = max(r["bytes"] / PEAK_BYTES_PER_S,
                        r["ops"] / PEAK_OPS_PER_S) * 1e3
            share = f"{bound / dev_ms:.1%}" if dev_ms else "not measured"
            print(f"  {name}[{mode}] {r['shape']}: {fmt_ms(dev_ms)} kernel "
                  f"device time, {r['ms']:.4f} ms back to back, plain "
                  f"{r['plain_ms']:.3f} ms on the card; bound {bound:.5f} ms "
                  f"({r['bytes']} bytes, {r['ops']} operations): {share} of "
                  f"the bound; max_abs_err {err} against the plain version "
                  f"on CPU copies; launches in phase 14's counted run "
                  f"{r['launches']}; card {card}", flush=True)
            require(err == 0, f"{name}[{mode}] {label}: kernel vs plain "
                    "differ")
            rows.append(r)
    return rows


def lane_step_ops(step) -> tuple:
    """(merge ops, LWW ops) of one testing/lanes.scenario step."""
    if step[0] not in ("window", "backlog"):
        return 0, 0
    merge = sum(len(v) for v in step[1].values())
    lww = sum(len(v) for v in step[2].values()) if step[0] == "window" \
        else 0
    return merge, lww


def lane_results(run: dict, merge, lww, hits: float) -> dict:
    """testing/lanes.store_results plus the run's extracts and seeds, as
    JSON would carry them."""
    from fluidframework_tpu_torch.testing import lanes
    res = lanes.store_results(merge, lww)
    res["seeded"] = lanes.named_extract(run["seeded"])
    res["extracts"] = [lanes.named_extract(e) for e in run["extracts"]]
    res["blob_cache_hits"] = hits
    return json.loads(json.dumps(res, sort_keys=True))


def lane_digest(res: dict) -> dict:
    """lane_results in a form small enough to pass between processes:
    each per-channel map (texts, entries, placements, snapshots, each
    extract) as {channel: sha256 of its canonical JSON}; the rest as it
    is."""
    import hashlib

    def sha(v):
        return hashlib.sha256(json.dumps(v, sort_keys=True).encode()
                              ).hexdigest()[:24]

    out = {}
    for part, v in res.items():
        if part == "extracts":
            out[part] = [{k: sha(x) for k, x in e.items()} for e in v]
        elif isinstance(v, dict) and part in ("merge", "lww"):
            out[part] = {name: ({k: sha(x) for k, x in m.items()}
                                if name in ("text", "entries", "snapshot")
                                else m) for name, m in v.items()}
        else:
            out[part] = v
    return json.loads(json.dumps(out, sort_keys=True))


def run_lane_stores(steps, device, timer=None, after=None,
                    results=True, stores=("bucketed", "paged")) -> dict:
    """The scenario through a bucketed MergeLaneStore with an
    LwwLaneStore, then a paged MergeLaneStore, on `device`. timer(store,
    label, fn) runs each store call; after(store, label) runs after each.
    Returns {"bucketed": results, "paged": results} (lane_results; {} each
    with results=False)."""
    from fluidframework_tpu_torch.server import tpu_sequencer as seq
    from fluidframework_tpu_torch.telemetry import counters
    from fluidframework_tpu_torch.testing import lanes
    out = {}
    for name in stores:
        paged = name == "paged"
        merge = seq.MergeLaneStore(paged=paged, device=device)
        lww = None if paged else seq.LwwLaneStore(device=device)

        def each(label, fn, name=name):
            got = fn() if timer is None else timer(name, label, fn)
            if after is not None:
                after(name, label)
            return got

        h0 = counters.get("summarize.blob_cache.hits")
        run = lanes.run_scenario(steps, merge, lww, each)
        out[name] = lane_results(
            run, merge, lww, counters.get("summarize.blob_cache.hits") - h0
        ) if results else {}
        del merge, lww
    return out


def lane_cpu_main(args: str, store: str) -> int:
    """Phase 15's CPU composition of one store ("bucketed", with the LWW
    store, or "paged") in a process of its own: the scenario of `args`
    (JSON: the FleetSpec, seed, backlog ops, dirty stride, as
    lane_store_phase passes them) on device="cpu"; prints {"seconds",
    "digests"} (lane_digest of the store's results) as one JSON line."""
    from fluidframework_tpu_torch.testing import lanes
    from fluidframework_tpu_torch.testing.serving import DocClass, FleetSpec
    torch.set_num_threads(LANE_CPU_THREADS)
    t0 = time.perf_counter()
    spec, seed, backlog, stride = json.loads(args)
    spec = FleetSpec(tuple(DocClass(*c) for c in spec[0]), *spec[1:])
    steps = lanes.scenario(spec, seed, backlog, stride)
    res = run_lane_stores(steps, "cpu", stores=(store,))
    print(json.dumps({"seconds": time.perf_counter() - t0,
                      "digests": {k: lane_digest(v)
                                  for k, v in res.items()}}), flush=True)
    return 0


def start_lane_twins() -> dict:
    """Phase 15's CPU composition, a child process per store, started
    right after the kernel build so that it runs beside phases 1-14 and
    is done, or nearly, when phase 15 reads it (the paged store's takes
    the longest). Killed at exit if still running."""
    from fluidframework_tpu_torch.testing import serving
    spec = getattr(serving, LANE_SPEC)
    procs = {store: subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "lane_cpu_main(sys.argv[1], sys.argv[2]))",
         json.dumps([spec, LANE_SEED, LANE_BACKLOG, LANE_DIRTY_STRIDE]),
         store], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
        for store in ("bucketed", "paged")}
    atexit.register(stop_twins, list(procs.values()))
    return procs


def start_lambda_twins() -> dict:
    """Phase 16's CPU twins (lambda_cpu_main), a child process per
    layout, started when phase 15's card run ends, while phase 15 waits
    for its own twins. Killed at exit if still running."""
    procs = {layout: subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "lambda_cpu_main(sys.argv[1]))", layout],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
        for layout in ("bucketed", "paged")}
    atexit.register(stop_twins, list(procs.values()))
    return procs


def start_server_twins() -> dict:
    """Phase 17's CPU twins (server_cpu_main), a child process per
    layout, started when phase 16's card part ends, while phase 16 waits
    for its own twins. Killed at exit if still running."""
    procs = {layout: subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "server_cpu_main(sys.argv[1]))", layout],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
        for layout in ("bucketed", "paged")}
    atexit.register(stop_twins, list(procs.values()))
    return procs


def stop_twins(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def lane_store_phase(dev, card: str, cpu_procs: dict,
                     after_card=None) -> list:
    """Phase 15, the sequencer's lane stores (server/tpu_sequencer.py).
    (a) testing/lanes.golden_run on the card against the committed JAX
    golden (states, results, extracts). (b) The partition: LANE_SPEC's
    10,000 merge channels in three classes over its 8 windows, 1,000
    SharedMap channels + the wide map, the hot channels seeded from 3,500
    entries each, then a LANE_BACKLOG-op backlog on every storm and hot
    channel with the annotate storm on channel 0, extract_all, a dirty
    pass on every LANE_DIRTY_STRIDE-th channel, extract_all again; through
    a bucketed store (+ the LWW store) and a paged store on the card with
    the counts at 0, each scan-apply launch event-timed and checked to
    take the rule's geometry, each store call timed by the host clock
    around a synced call. (c) The same stores on the CPU over the same
    schedules, in the child processes `cpu_procs` (start_lane_twins,
    started after the kernel build): equal results (placements, texts, entries, recovery
    counts, extracts, LWW snapshots). (d) The bucketed and the paged
    store agree (testing/lanes.cross_store_mismatches); promotions, folds,
    rescues, page compactions and the paged burst happened; every launch
    shape is a power of two and a replay of the windows through fresh
    stores adds no apply signature.
    Returns the scan kernel's rows at the LANE_ROW_SHAPES largest store
    shapes (every path timed; the rule's within PATH_MARGIN).
    `after_card`, if given, is called when the card's run ends, before
    the wait for the CPU composition (it starts the next phase's twins)."""
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.server import tpu_sequencer as seq
    from fluidframework_tpu_torch.telemetry import counters
    from fluidframework_tpu_torch.telemetry.compile_ledger import ledger
    from fluidframework_tpu_torch.testing import golden, lanes, serving

    t_phase = time.perf_counter()
    split = {}
    # -- (a) the JAX golden at its small size --------------------------------
    g = golden.load_lanes()
    sections, doc = lanes.golden_run(seq, counters, device=dev)
    for name, sec in sections.items():
        for f, arr in sec.items():
            want = g[name][f]
            require(arr.dtype == want.dtype and np.array_equal(arr, want),
                    f"phase 15 golden: {name}.{f} differs from JAX")
    require(json.loads(json.dumps(doc, sort_keys=True)) == g["json"],
            "phase 15 golden: the card's lane stores differ from JAX")
    print(f"phase 15 (a): the lane stores on the card equal the JAX golden "
          f"({len(sections)} state sections; counts "
          f"{doc['bucketed']['merge']['counts']} bucketed, "
          f"{doc['paged']['merge']['counts']} paged)", flush=True)
    split["golden"] = time.perf_counter() - t_phase

    # -- (b) the partition on the card --------------------------------------
    spec = getattr(serving, LANE_SPEC)
    t0 = time.perf_counter()
    steps = lanes.scenario(spec, LANE_SEED, LANE_BACKLOG, LANE_DIRTY_STRIDE)
    gen_s = time.perf_counter() - t0
    labels, w = [], 0
    for step in steps:
        if step[0] == "window":
            labels.append((f"window{w}", lane_step_ops(step)))
            w += 1
        elif step[0] == "backlog":
            labels.append(("backlog", lane_step_ops(step)))
    ops_of = dict(labels)

    captured, events, off_rule = {}, [], []
    launch = kernel._launch

    def counted_launch(state, ops, runs, geo):
        b, c = state.length.shape
        variant = "runs" if runs is not None else "plain"
        key = (b, c, ops.steps, variant)
        if geo != kernel.scan_geometry(b, c, state.overlap_slots,
                                       state.anno_slots):
            off_rule.append((key, geo))
        if key not in captured:
            captured[key] = (clone_state(state), clone_state(ops),
                             None if runs is None else clone_state(runs))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(state, ops, runs, geo)
        e1.record()
        events.append((f"{geo.path}[{variant}]", key, e0, e1))
        return out

    times = {"bucketed": {}, "paged": {}}
    sigs = {"bucketed": {}, "paged": {}}

    def timer(store, label, fn):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        times[store][label] = (time.perf_counter() - h0) * 1e3
        return got

    def after(store, label):
        sigs[store][label] = (seq._apply_keep_batched._cache_size(),
                              seq._apply_paged_probe._cache_size())

    ledger.reset()
    kernel.reset_launches()
    kernel.reset_zamboni_launches()
    reset_window_counts()
    kernel._launch = counted_launch
    t0 = time.perf_counter()
    try:
        with PlainLwwGuard() as guard, PlainZamboniGuard() as zguard:
            card_res = run_lane_stores(steps, dev, timer, after)
            torch.cuda.synchronize()
    except BaseException:
        stop_twins(cpu_procs.values())
        raise
    finally:
        kernel._launch = launch
    card_s = split["card"] = time.perf_counter() - t0
    lww_n = window_counts()["lww_scan"]
    require(lww_n > 0 and guard.cuda_calls == 0, f"phase 15: the LWW store "
            f"launched the lane scan {lww_n} times and ran its plain "
            f"version {guard.cuda_calls} times on the card's tensors")
    z_counts = zamboni_counts()
    require(z_counts["compact"] > 0 and z_counts["compact_extract"] > 0
            and z_counts["narrow_pack"] > 0 and zguard.cuda_calls == 0,
            f"phase 15: the lane stores launched zamboni.cu and "
            f"narrow_pack.cu {z_counts} times and ran the plain compaction, "
            f"extraction or narrow pack {zguard.cuda_calls} times on the "
            f"card's tensors")
    launches = {k: n for k, n in kernel.scan_apply.kernel_launches.items()
                if n}
    syms = ledger.snapshot()["symbols"]
    bursts = syms.get("serve.paged_burst", {})
    n_bursts = bursts.get("coldCalls", 0) + bursts.get("warmCalls", 0)

    # -- (c) the CPU composition, from the process started above -------------
    warm_sigs = (seq._apply_keep_batched._cache_size(),
                 seq._apply_paged_probe._cache_size())
    if after_card is not None:
        after_card()
    t0 = time.perf_counter()
    cpu_dig, cpu_secs = {}, {}
    try:
        for store, proc in cpu_procs.items():
            text, _ = proc.communicate(timeout=LANE_CPU_TIMEOUT)
            require(proc.returncode == 0, f"phase 15: the {store} store's "
                    f"CPU composition exited {proc.returncode}")
            got = json.loads(text.strip().splitlines()[-1])
            cpu_dig.update(got["digests"])
            cpu_secs[store] = round(got["seconds"], 1)
    finally:
        stop_twins(cpu_procs.values())
    waited_s = split["cpu_wait"] = time.perf_counter() - t0

    # -- prints ----------------------------------------------------------------
    by_path = {}
    for label, key, e0, e1 in events:
        n, ms = by_path.get(label, (0, 0.0))
        by_path[label] = (n + 1, ms + e0.elapsed_time(e1))
    path_ms = {k: (n, round(ms, 3)) for k, (n, ms) in by_path.items()}
    shapes = {}
    for label, key, _e0, _e1 in events:
        shapes[key] = shapes.get(key, 0) + 1
    print(f"phase 15 (b): {LANE_SPEC} ({spec.docs} documents) scenario "
          f"generated in {gen_s:.2f} s; the card's run {card_s:.1f} s, the "
          f"CPU's {cpu_secs} s in a process per store, started after the "
          f"kernel build (waited {waited_s:.1f} s after the card's); scan "
          f"launches "
          f"{launches}; by path (count, "
          f"event ms) {path_ms}; shapes (B, C, T, variant): launches "
          f"{dict(sorted(shapes.items()))}; serve.paged_burst calls "
          f"{n_bursts}; zamboni.cu launches by mode and narrow_pack.cu "
          f"launches {z_counts}; card {card}", flush=True)
    for store in ("bucketed", "paged"):
        t = times[store]
        wins = [(lb, t[lb]) for lb, _ in labels if lb.startswith("window")]
        win_ms = [ms for _lb, ms in wins]
        rates = [ops_of[lb][0] / (ms / 1e3) for lb, ms in wins]
        print(f"phase 15 {store}: window apply ms (host clock, synced) "
              f"{[round(ms, 3) for ms in win_ms]}, p50 "
              f"{float(np.median(win_ms)):.3f} ms, ops/s per window "
              f"{[round(r) for r in rates]} (p50 "
              f"{float(np.median(rates)):.0f}); seed "
              f"{t.get('seed', 0):.1f} ms; backlog "
              f"({ops_of['backlog'][0]} ops) {t['backlog']:.1f} ms; "
              f"extract_all full {t['extract0']:.1f} ms, dirty "
              f"{t['extract1']:.1f} ms; blob-cache hits "
              f"{card_res[store]['blob_cache_hits']:.0f}; recovery "
              f"{card_res[store]['merge']['counts']}; apply signatures "
              f"after each call {sigs[store]}; card {card}", flush=True)
    lww_ms = [ms for lb, ms in times["bucketed"].items()
              if lb.startswith("lww")]
    lww_where = card_res["bucketed"]["lww"]["where"]
    lww_p50 = float(np.median(lww_ms))
    print(f"phase 15 LWW: {len(lww_where)} channels, {lww_n} lww_scan "
          f"launches, apply ms per window "
          f"{[round(x, 3) for x in lww_ms]} (p50 {lww_p50:.3f} ms, "
          f"{ops_of['window0'][1] / (lww_p50 / 1e3):.0f} ops/s); the wide "
          f"map at {lww_where['|'.join(lanes.WIDE_MAP_KEY)]}; card {card}",
          flush=True)

    # -- (d) checks ---------------------------------------------------------------
    for store in ("bucketed", "paged"):
        got, want = lane_digest(card_res[store]), cpu_dig[store]
        for part in sorted(set(got) | set(want)):
            if got.get(part) == want.get(part):
                continue
            diff = part
            if isinstance(got.get(part), dict):
                diff = [(part, n) for n in got[part]
                        if got[part][n] != want.get(part, {}).get(n)]
            require(False, f"phase 15 {store}: {diff} differs between the "
                    "card and the CPU")
    bad = lanes.cross_store_mismatches(
        card_res["bucketed"], card_res["paged"],
        (card_res["bucketed"]["extracts"], card_res["paged"]["extracts"]))
    require(not bad, f"phase 15: bucketed vs paged: {bad[:5]}")
    require(not off_rule, f"phase 15: launches off the rule: {off_rule[:3]}")
    require(sum(launches.values()) == len(events) > 0,
            f"phase 15: scan launches {launches} vs {len(events)} events")
    bc = card_res["bucketed"]["merge"]["counts"]
    pc = card_res["paged"]["merge"]["counts"]
    where = card_res["bucketed"]["merge"]["where"].values()
    require(bc["folds"] > 0 and max(b for b, _ in where) == 2
            and bc["fold_rescue_dispatches"] > 0,
            f"phase 15: the bucketed store never folded or promoted to "
            f"the last bucket: {bc}")
    require(pc["paged_rescues"] > 0 and pc["page_compactions"] > 0
            and n_bursts > 0, f"phase 15: the paged store took no rescue, "
            f"page compaction or burst: {pc}, {n_bursts} bursts")
    require(card_res["paged"]["blob_cache_hits"] > 0
            and card_res["bucketed"]["blob_cache_hits"] > 0,
            "phase 15: the dirty pass took nothing from the blob cache")
    # The apply signatures grow by pow2 steps while lanes promote and page
    # groups widen; every launch shape is a power of two in each dimension
    # (a bounded set), and the same traffic run again (the golden run's
    # and the card's first store warmed them) adds none: checked below on
    # a replay of the card's windows through fresh stores.
    odd = [k for k in shapes if any(x & (x - 1) for x in k[:3])]
    require(not odd, f"phase 15: launch shapes off the pow2 grid: {odd}")
    t0 = time.perf_counter()
    replay = [st for st in steps if st[0] != "backlog"]
    run_lane_stores(replay[:1 + spec.windows], dev, results=False)
    torch.cuda.synchronize()
    replay_s = split["replay"] = time.perf_counter() - t0
    grown = (seq._apply_keep_batched._cache_size(),
             seq._apply_paged_probe._cache_size())
    require(grown == warm_sigs, f"phase 15: a replay of the same windows "
            f"added apply signatures: {warm_sigs} -> {grown}")
    print(f"phase 15 (c, d): card == CPU for both stores and the LWW "
          f"store; bucketed vs paged agree; every launch on the rule's "
          f"geometry, every launch shape a power of two; the apply "
          f"signatures (merge_apply_batched, paged_apply) {warm_sigs} "
          f"stay flat through a replay of the seed and the "
          f"{spec.windows} windows ({replay_s:.1f} s)", flush=True)

    # -- the scan kernel's rows at the store's largest shapes ------------------
    t0 = time.perf_counter()
    rows = []
    biggest = sorted(captured, key=lambda k: -k[0] * k[1] * k[2])
    most = max(shapes, key=shapes.get)
    pick = biggest[:LANE_ROW_SHAPES] + ([most] if most not in
                                        biggest[:LANE_ROW_SHAPES] else [])
    for key in pick:
        state, ops, runs = captured[key]
        b, c, t, variant = key
        rows += scan_rows(f"lane store, {shapes[key]} launch(es)", state,
                          ops, runs, launches, 3,
                          f"{b} x C={c} x T={t}", card)
    split["rows"] = time.perf_counter() - t0
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s (seconds by "
          f"part {({k: round(v, 1) for k, v in split.items()})})",
          flush=True)
    return rows


def lambda_cpu_main(layout: str) -> int:
    """Phase 16's CPU twin of one layout ("bucketed" or "paged") in a
    process of its own: the serving-ingest fleet at its full width through
    the port's lambda on device="cpu"; prints the scenario's digests as
    one JSON line."""
    from fluidframework_tpu_torch.testing import golden, lambda_runs
    torch.set_num_threads(LAMBDA_CPU_THREADS)
    t0 = time.perf_counter()
    res = lambda_runs.serving_run(lambda_runs.port_package("cpu"),
                                  *golden.LAMBDA_SERVING,
                                  measured=LAMBDA_MEASURED,
                                  extra=LAMBDA_EXTRA,
                                  paged=layout == "paged")
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


def lambda_counts():
    """The lambda path's kernel counts: ticket scan, fused apply by
    variant and path, scan apply by kernel."""
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    got = {"ticket_scan": tk.scan_tickets.launches,
           "fused_apply": pa.apply_ops_fused.launches,
           "scan_apply": kernel.scan_apply.launches}
    got.update(window_counts())
    got.update({f"fused_apply[{v}]": n for v, n in
                pa.apply_ops_fused.variant_launches.items() if n})
    got.update({f"fused_apply<{p}>": n for p, n in
                pa.apply_ops_fused.path_launches.items() if n})
    got.update({f"scan_apply:{k}": n for k, n in
                kernel.scan_apply.kernel_launches.items() if n})
    return got


def window_counts() -> dict:
    """The serving window's kernels' counts: the LWW lane scan (both
    modes), the merge admission and the flat16 pack."""
    from fluidframework_tpu_torch.server import lww_kernel as lk
    from fluidframework_tpu_torch.server import serve_step as ss
    return {"lww_scan": lk.apply_lww_batched.launches,
            "window_admit": ss.admit_merge_ops.launches,
            "window_pack": ss._pack_window.launches}


def reset_window_counts() -> None:
    from fluidframework_tpu_torch.server import lww_kernel as lk
    from fluidframework_tpu_torch.server import serve_step as ss
    lk.apply_lww_batched.launches = 0
    ss.admit_merge_ops.launches = 0
    ss._pack_window.launches = 0


class PlainGuard:
    """While on, counts the calls of a module's plain versions (`names`)
    whose first argument's first tensor lies on the card: the main path
    must make none."""

    module: str = ""
    names: tuple = ()

    def __enter__(self):
        import importlib
        self.mod, self.cuda_calls = importlib.import_module(self.module), 0
        self.saved = {n: getattr(self.mod, n) for n in self.names}

        def counted(fn):
            def call(first, *args, **kwargs):
                self.cuda_calls += first[0].device.type == "cuda"
                return fn(first, *args, **kwargs)
            return call
        for n, fn in self.saved.items():
            setattr(self.mod, n, counted(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.mod, n, fn)
        return False


class PlainLwwGuard(PlainGuard):
    """The LWW lane scan's plain versions (lww_kernel.
    apply_lww_batched_plain and apply_lww_window_plain) on the card's
    tensors."""

    module = "fluidframework_tpu_torch.server.lww_kernel"
    names = ("apply_lww_batched_plain", "apply_lww_window_plain")


class PlainZamboniGuard(PlainGuard):
    """The plain compaction, extraction and narrow pack (kernel.
    compact_batched_plain, extract_visible_batched_plain,
    compact_extract_batched_plain, narrow_pack_plain) on the card's
    tensors."""

    module = "fluidframework_tpu_torch.mergetree.kernel"
    names = ("compact_batched_plain", "extract_visible_batched_plain",
             "compact_extract_batched_plain", "narrow_pack_plain")


def zamboni_counts() -> dict:
    """The zamboni kernel's launches by mode and the narrow pack's."""
    from fluidframework_tpu_torch.mergetree import kernel
    got = dict(kernel.zamboni.mode_launches)
    got["narrow_pack"] = kernel.narrow_pack.launches
    return got


def zamboni_since(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in zamboni_counts().items()}


def print_zamboni_launches(phase: str, before: dict) -> None:
    print(f"phase {phase}: zamboni.cu launches by mode and narrow_pack.cu "
          f"launches in the phase {zamboni_since(before)}", flush=True)


def counts_since(before: dict) -> dict:
    """The lambda path's launches since `before` (a lambda_counts())."""
    return {k: n - before.get(k, 0) for k, n in lambda_counts().items()
            if n != before.get(k, 0)}


def reset_lambda_counts() -> None:
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    tk.scan_tickets.launches = 0
    pa.reset_launches()
    kernel.reset_launches()
    reset_window_counts()


SERVING_COUNTERS = ("serving.window_dispatches", "serving.bursts",
                    "serving.burst_windows", "serving.recovery_dispatches",
                    "serving.megakernel_rings")


def lambda_serving(dev, card: str, layout: str, want: dict) -> dict:
    """Phase 16 (a), one layout: the serving-ingest fleet at its full
    width through handler_raw with emit_window and the pipelined ring.
    The measured waves run with the counts at 0, timed by the host clock
    (feed, flush, the final drain, synced) and traced by the profiler for
    the device's busy share; the extra wave, in which the fleet's next
    lane recovery lands, is timed alone. The digests must equal the JAX
    golden's."""
    from fluidframework_tpu_torch.telemetry import counters
    from fluidframework_tpu_torch.testing import golden, lambda_runs
    docs, ops = golden.LAMBDA_SERVING
    facts = {}

    def measure(lam, run):
        before = {n: counters.get(n) for n in SERVING_COUNTERS}
        launched = lambda_counts()
        flush_ms = []

        def timed():
            t0 = time.perf_counter()
            run(flush_ms)
            lam.drain()
            torch.cuda.synchronize()
            facts["wall_s"] = time.perf_counter() - t0

        facts["busy_ms"] = device_busy_ms(timed)
        facts["counts"] = counts_since(launched)
        facts["flush_ms"] = flush_ms
        facts["counters"] = {n: counters.get(n) - before[n]
                             for n in SERVING_COUNTERS}

    def extra(lam, run):
        launched = lambda_counts()
        flush_ms = []
        run(flush_ms)
        lam.drain()
        torch.cuda.synchronize()
        facts["extra_flush_ms"] = flush_ms
        facts["extra_counts"] = counts_since(launched)

    t0 = time.perf_counter()
    res = lambda_runs.serving_run(lambda_runs.port_package(dev), docs, ops,
                                  measured=LAMBDA_MEASURED,
                                  extra=LAMBDA_EXTRA,
                                  paged=layout == "paged",
                                  hooks={"measure": measure,
                                         "extra": extra})
    total_s = time.perf_counter() - t0
    for key in want:
        require(res[key] == want[key], f"phase 16 (a) {layout}: {key} "
                f"{res[key]} differs from the JAX golden {want[key]}")
    c = facts["counters"]
    windows = c["serving.window_dispatches"] + c["serving.burst_windows"]
    dispatches = c["serving.window_dispatches"] + c["serving.bursts"] \
        + c["serving.recovery_dispatches"]
    n_ops = LAMBDA_MEASURED * docs * ops
    counts = facts["counts"]
    require(counts.get("ticket_scan", 0) > 0
            and counts.get("fused_apply", 0) > 0,
            f"phase 16 (a) {layout}: the measured waves did not launch the "
            f"ticket scan and the fused apply: {counts}")
    busy = facts["busy_ms"]
    busy_share = None if busy is None else busy / (facts["wall_s"] * 1e3)
    per_window = {k: round(n / windows, 3) for k, n in counts.items()} \
        if windows else {}
    print(f"phase 16 (a) {layout}: {docs} documents x {ops} ops a wave, "
          f"{LAMBDA_MEASURED} measured waves: {n_ops / facts['wall_s']:.0f} "
          f"ops/s warm (host clock, feed + flush + drain), flush ms "
          f"{[round(x, 2) for x in facts['flush_ms']]} (p50 "
          f"{float(np.median(facts['flush_ms'])):.2f}); {windows:.0f} "
          f"windows, {dispatches:.0f} dispatches ({dispatches / windows:.3f} "
          f"a window; counters {c}); kernel launches {counts}, per window "
          f"{per_window}; device busy {fmt_ms(busy)} of the measured "
          f"waves' {facts['wall_s'] * 1e3:.1f} ms (busy share "
          f"{'not measured' if busy_share is None else f'{busy_share:.1%}'}"
          f"; the profiler traced the measured waves); the extra wave's "
          f"flush (a lane recovery lands in it) "
          f"{facts['extra_flush_ms'][0]:.1f} ms, its kernel launches "
          f"{facts['extra_counts']}; the emitted stream "
          f"({res['stream']['admitted']} messages) "
          f"and the texts ({res['texts']['chars']} chars) equal the JAX "
          f"golden; {total_s:.1f} s in all; card {card}", flush=True)
    return res


def lambda_phase(dev, card: str, twins: dict = None,
                 after_card=None) -> list:
    """Phase 16, the sequencer lambda (server/tpu_sequencer.
    TpuSequencerLambda) on the card, client_timeout_s=0.0, through the
    scenarios of testing/lambda_runs.py. The kernel counts are set to 0
    at the start; the lambda must launch the ticket scan, the fused apply
    and the scan apply.
    (a) The serving-ingest fleet at its full width (testing/golden.
    LAMBDA_SERVING: 4,096 documents, 32 ops a document a wave, each boxcar
    on one refSeq, ingest.warm_waves warm waves, LAMBDA_MEASURED measured
    and profiled, LAMBDA_EXTRA more), bucketed and paged: warm ops/s, flush p50,
    dispatches and kernel launches per window, the device's busy share;
    the emitted stream and the texts held to the JAX golden and to the
    port's CPU twin (a child process per layout, started while phase 15
    waited for its own).
    (b) The ragged storm fleet on paged lanes: the megakernel stream
    order-identical to the per-window (sync) stream, fewer than 0.25
    dispatches per served window, both equal to the JAX golden.
    (c) The mixed-family stream (LAMBDA_MIXED: 1,024 documents), half
    through handler, a restart from the checkpoint and the delta store,
    half through handler_raw; summaries and catch-up artifacts; equal to
    the JAX golden. Each launch of the LWW lane scan is timed with CUDA
    events (its stage time, launches and bytes), and the largest
    lane-store launch is held to the plain version and timed (the
    returned kernel row). No plain LWW call may touch the card's tensors
    in the phase, and the window's kernels must launch."""
    from fluidframework_tpu_torch.server import lww_kernel
    from fluidframework_tpu_torch.server import tpu_sequencer as seq
    from fluidframework_tpu_torch.testing import golden, lambda_runs

    t_phase = time.perf_counter()
    g = golden.load_lambda()
    # The CPU twins (LAMBDA_CPU_THREADS threads each) run beside the
    # card's run, as phase 15's do: the host's other cores are theirs.
    # main starts them while phase 15 waits for its own (`twins`).
    if not twins:
        twins = start_lambda_twins()
    guard = PlainLwwGuard().__enter__()
    try:
        reset_lambda_counts()
        # Each part's launches, counted from where the last part ended.
        parts = {}
        card_res = {}
        for layout in ("bucketed", "paged"):
            launched = lambda_counts()
            card_res[layout] = lambda_serving(dev, card, layout,
                                              g["serving"][layout])
            parts[f"(a) {layout}"] = counts_since(launched)

        # -- (b) the ragged storm fleet -------------------------------------
        pkg = lambda_runs.port_package(dev)
        storm = {}
        for mode in ("sync", "mega"):
            launched = lambda_counts()
            storm[mode] = lambda_runs.storm_run(pkg, mode)
            parts[f"(b) {mode}"] = counts_since(launched)
        require(storm["mega"]["stream"] == storm["sync"]["stream"],
                "phase 16 (b): the megakernel stream differs from the "
                "per-window stream")
        per_window = storm["mega"]["dispatches_per_window"]
        require(per_window is not None and per_window < 0.25,
                f"phase 16 (b): {per_window} dispatches per served window")
        # The JAX megakernel, which made the golden, loses the storm
        # document's text (its chunks dispatch back to back on stale page
        # scalars); the port drains between chunks, so its megakernel
        # texts are held to the sync texts, which JAX has right.
        require(storm["sync"] == g["storm"]["sync"], f"phase 16 (b): the "
                f"sync run differs from the JAX golden: {storm['sync']} vs "
                f"{g['storm']['sync']}")
        for key in ("messages", "stream", "rings", "served_windows"):
            require(storm["mega"][key] == g["storm"]["mega"][key],
                    f"phase 16 (b): the megakernel run's {key} differs "
                    f"from the JAX golden: {storm['mega'][key]} vs "
                    f"{g['storm']['mega'][key]}")
        require(storm["mega"]["texts"] == storm["sync"]["texts"],
                "phase 16 (b): the megakernel texts differ from the "
                "per-window texts")
        print(f"phase 16 (b): the storm fleet's megakernel stream "
              f"({storm['mega']['messages']} messages) is order-identical "
              f"to the per-window stream, {per_window:.4f} dispatches per "
              f"served window ({storm['mega']['rings']} rings, "
              f"{storm['mega']['served_windows']} windows), its texts equal "
              f"the per-window texts; the streams equal the JAX golden; "
              f"card {card}", flush=True)

        # -- (c) the mixed-family stream, the LWW apply timed --------------
        # Every launch of the LWW lane scan (the lane store's and the
        # window's), timed by CUDA events; the largest lane-store launch
        # is kept for the kernel row.
        launch_lww = lww_kernel._launch
        lww_calls, largest = [], {}

        def timed_lww(state, ops, *window):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = launch_lww(state, ops, *window)
            e1.record()
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*state, *out[0]))
            if ops is not None:
                nbytes += sum(t.numel() * t.element_size() for t in ops)
                if state.key.numel() > largest.get("cells", -1):
                    largest.update(cells=state.key.numel(),
                                   state=clone_state(state),
                                   ops=clone_state(ops))
            shape = tuple(state.key.shape) + (
                (ops.kind.shape[-1],) if ops is not None
                else (window[0].shape[-1],))
            lww_calls.append((e0, e1, nbytes, shape))
            return out

        lww_kernel._launch = timed_lww
        # The stream's undecodable frames are counted (mixed["poison"]);
        # their one warning each stays off the output.
        log = logging.getLogger(seq.__name__)
        level = log.level
        log.setLevel(logging.ERROR)
        t0 = time.perf_counter()
        launched = lambda_counts()
        try:
            mixed = lambda_runs.mixed_run(pkg, *golden.LAMBDA_MIXED)
            torch.cuda.synchronize()
        finally:
            lww_kernel._launch = launch_lww
            log.setLevel(level)
        parts["(c)"] = counts_since(launched)
        mixed_s = time.perf_counter() - t0
        for key in g["mixed"]:
            require(mixed[key] == g["mixed"][key], f"phase 16 (c): {key} "
                    f"{mixed[key]} differs from the JAX golden "
                    f"{g['mixed'][key]}")
        lww_ms = sum(a.elapsed_time(b) for a, b, _n, _s in lww_calls)
        lww_bytes = sum(n for _a, _b, n, _s in lww_calls)
        print(f"phase 16 (c): the mixed stream ({mixed['docs']} documents, "
              f"{mixed['messages']} messages, {mixed['nacks']} nacks, "
              f"{mixed['poison']} poison frames, {mixed['promoted']} lanes "
              f"promoted, a restart restoring {mixed['restored_docs']} "
              f"documents, {mixed['catchup_docs']} catch-up artifacts) "
              f"equals the JAX golden: stream, nacks, views, summaries, "
              f"catch-up; {mixed_s:.1f} s; card {card}", flush=True)
        shapes = sorted({s for _a, _b, _n, s in lww_calls})
        print(f"phase 16 LWW apply (lww_kernel._launch, the lww_scan.cu "
              f"kernel): {len(lww_calls)} launches, {lww_ms:.3f} ms by CUDA "
              f"events in all ({lww_ms / max(1, len(lww_calls)):.4f} ms a "
              f"launch), {lww_bytes} bytes read and written: bound "
              f"{lww_bytes / PEAK_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; "
              f"shapes [B, C, T] {shapes[:8]}; card {card}", flush=True)
        counts = lambda_counts()
        require(counts["ticket_scan"] > 0 and counts["fused_apply"] > 0
                and counts["scan_apply"] > 0 and counts["lww_scan"] > 0
                and counts["window_admit"] > 0
                and counts["window_pack"] > 0, f"phase 16: the lambda did "
                f"not launch every kernel of its path: {counts}")
        require(guard.cuda_calls == 0, f"phase 16: the plain LWW scan ran "
                f"{guard.cuda_calls} times on the card's tensors")
        summed = {k: sum(p.get(k, 0) for p in parts.values())
                  for k in counts}
        require(summed == counts, f"phase 16: the parts' launches {parts} "
                f"do not add up to the phase's {counts}")
        for name, part in parts.items():
            print(f"phase 16 {name}: kernel launches {part}", flush=True)
        print(f"phase 16: the lambda's kernel launches, all parts (counts "
              f"from 0 at the phase's start) {counts}", flush=True)
        # The row's own launches come after the phase's counts.
        require(bool(largest), "phase 16 (c): the LWW store launched no "
                "lane scan")
        st, ops = largest["state"], largest["ops"]
        table, n_ops = lww_work(st, ops.kind)
        b, t = ops.kind.shape
        rows = [window_row(
            "lww_scan", "lane_store", card, parts["(c)"].get("lww_scan", 0),
            lambda: lww_kernel.apply_lww_batched(st, ops),
            lambda: lww_kernel.apply_lww_batched_plain(st, ops), flat_tree,
            "lww_scan_kernel",
            f"[{b} lanes x C {st.key.shape[1]}] x T {t} (phase 16 (c)'s "
            "largest lane-store launch)", table + b * t * 20, n_ops)]

        # -- (a) the CPU twin -------------------------------------------------
        if after_card is not None:
            after_card()
        t0 = time.perf_counter()
        for layout, proc in twins.items():
            text, _ = proc.communicate(timeout=LAMBDA_CPU_TIMEOUT)
            require(proc.returncode == 0, f"phase 16: the {layout} CPU twin "
                    f"exited {proc.returncode}")
            twin = json.loads(text.strip().splitlines()[-1])
            for key in card_res[layout]:
                require(twin[key] == card_res[layout][key],
                        f"phase 16 (a) {layout}: {key} differs between the "
                        f"card and the CPU twin")
            print(f"phase 16 (a) {layout}: the card equals the CPU twin "
                  f"({twin['seconds']:.1f} s in its process; waited "
                  f"{time.perf_counter() - t0:.1f} s after the card)",
                  flush=True)
    finally:
        guard.__exit__(None, None, None)
        stop_twins(twins.values())
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def server_cpu_main(layout: str) -> int:
    """Phase 17's CPU twin of one layout ("bucketed" or "paged") in a
    process of its own: testing/server_runs.py at golden.SERVER_CARD
    through the port's TpuLocalServer(device="cpu"); prints the scenario's
    digests as one JSON line."""
    from fluidframework_tpu_torch.testing import golden, server_runs
    torch.set_num_threads(SERVER_CPU_THREADS)
    t0 = time.perf_counter()
    res = server_runs.run(server_runs.port_package("cpu"),
                          server_runs.Spec(**golden.SERVER_CARD),
                          **server_runs.VARIANTS[layout])
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


def _clone(x):
    """A deep copy of a launch's arguments (tensors cloned)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def capture_largest_launches():
    """Wrap the launch paths of the ticket scan, the fused apply, the
    scan apply and the summary length so that, per (kernel, variant), the
    launch with the most work (documents x steps, x capacity for an
    apply, documents x capacity for the summary length) keeps a copy of
    its inputs. Returns (captured, restore)."""
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree import pallas_ops
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    captured, sizes = {}, {}
    saved = (tk._launch, pa._launch, kernel._launch, pallas_ops._launch)

    def keep(key, size, args):
        if size > sizes.get(key, -1):
            sizes[key] = size
            captured[key] = _clone(args)

    def ticket(state, ops, require_join):
        keep(("ticket_scan", "kind_require_join" if require_join
              else "plain"), ops.client.numel(), (state, ops, require_join))
        return saved[0](state, ops, require_join)

    def fused(state, ops, runs, extract, geo):
        keep(("fused_apply", pa.variant_name(runs, extract)),
             state.length.numel() * ops.steps, (state, ops, runs, extract))
        return saved[1](state, ops, runs, extract, geo)

    def scan(state, ops, runs, geo):
        keep(("scan_apply", "runs" if runs is not None else "plain"),
             state.length.numel() * ops.steps, (state, ops, runs))
        return saved[2](state, ops, runs, geo)

    def summary(state, entry, what):
        keep(("summary_len", None), state.length.numel(), (state,))
        return saved[3](state, entry, what)

    tk._launch, pa._launch, kernel._launch, pallas_ops._launch = \
        ticket, fused, scan, summary

    def restore():
        tk._launch, pa._launch, kernel._launch, pallas_ops._launch = saved
    return captured, restore


SERVER_STAGES = (("sequencer", "server.tpu_sequencer", "TpuSequencerLambda",
                  ("handler", "flush")),
                 ("scriptorium", "server.lambdas.scriptorium",
                  "ScriptoriumLambda", ("handler",)),
                 ("scribe", "server.lambdas.scribe", "ScribeLambda",
                  ("handler",)),
                 ("broadcaster", "server.lambdas.broadcaster",
                  "BroadcasterLambda", ("handler",)),
                 ("copier", "server.lambdas.copier", "CopierLambda",
                  ("handler",)))


def time_stages(stage_s: dict):
    """Time each lambda's handler (and the sequencer's flush) by the host
    clock into stage_s[stage] (seconds, summed). Returns restore."""
    import importlib
    saved = []
    for stage, mod, cls_name, methods in SERVER_STAGES:
        cls = getattr(importlib.import_module(
            f"fluidframework_tpu_torch.{mod}"), cls_name)
        for m in methods:
            orig = cls.__dict__[m]

            def timed(self, *a, _orig=orig, _stage=stage, **k):
                t0 = time.perf_counter()
                try:
                    return _orig(self, *a, **k)
                finally:
                    stage_s[_stage] += time.perf_counter() - t0
            setattr(cls, m, timed)
            saved.append((cls, m, orig))

    def restore():
        for cls, m, orig in saved:
            setattr(cls, m, orig)
    return restore


def server_layout(dev, card: str, layout: str, want: dict,
                  native_log: bool = False, watch=None,
                  phase: str = "phase 17"):
    """Phase 17, one layout: the scenario on TpuLocalServer(device=dev).
    The measured waves are timed per wave (submit, pump, the broadcaster's
    drain) and in all (synced), split by lambda, and traced by the
    profiler for the device's busy share; the tail (refresh_catchup,
    get_catchup, the full and the incremental materialized write) is
    timed call by call. Every digest must equal the JAX golden's. Phase
    18 (e) runs it over the C++ message log (native_log) with `watch`
    (start(server) before the measured waves, on_wave(i) after each,
    stop() after them) scraping the server. Returns (digests, figures)."""
    from collections import defaultdict

    from fluidframework_tpu_torch.testing import golden, server_runs
    facts = {}

    def measured(server, run_waves):
        waves = []
        stage_s = defaultdict(float)
        restore = time_stages(stage_s)

        def on_wave(*w):
            waves.append(w)
            if watch is not None:
                watch.on_wave(w[0])

        def timed():
            t0 = time.perf_counter()
            facts["ops"] = run_waves(on_wave)
            torch.cuda.synchronize()
            facts["wall_s"] = time.perf_counter() - t0

        if watch is not None:
            watch.start(server)
        try:
            # The profiler is process-wide: with a watch, the monitor's
            # /profile takes it, so the busy share is not measured here.
            facts["busy_ms"] = device_busy_ms(timed) if watch is None \
                else timed()
        finally:
            restore()
            if watch is not None:
                watch.stop()
        facts["waves"] = waves
        facts["stage_s"] = dict(stage_s)
        return facts["ops"]

    tails = {}

    def tail(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        tails[name] = (time.perf_counter() - t0) * 1e3
        return out

    t0 = time.perf_counter()
    res = server_runs.run(server_runs.port_package(dev),
                          server_runs.Spec(**golden.SERVER_CARD),
                          native_log=native_log,
                          hooks={"measured": measured, "tail": tail},
                          **server_runs.VARIANTS[layout])
    total_s = time.perf_counter() - t0
    for key in want:
        require(res[key] == want[key], f"{phase} {layout}: {key} "
                f"{res[key]} differs from the JAX golden {want[key]}")
    require(res["admission_nacks"] == 0 and res["shed"] == 0,
            f"{phase} {layout}: {res['admission_nacks']} admission nacks, "
            f"{res['shed']} fan-outs shed")
    pumps = sorted(w[3] * 1e3 for w in facts["waves"])
    wall_ms = facts["wall_s"] * 1e3
    split = {k: round(v * 1e3, 1) for k, v in facts["stage_s"].items()}
    split["drain"] = round(sum(w[4] for w in facts["waves"]) * 1e3, 1)
    split["submit"] = round(sum(w[2] for w in facts["waves"]) * 1e3, 1)
    busy = facts["busy_ms"]
    share = "not measured" if busy is None else f"{busy / wall_ms:.2%}"
    print(f"{phase} {layout}{' (C++ log)' if native_log else ''}: "
          f"{res['docs']} documents, "
          f"{len(facts['waves'])} measured waves of "
          f"{facts['ops'] // len(facts['waves'])} ops: "
          f"{facts['ops'] / facts['wall_s']:.0f} ops/s (host clock, the "
          f"first submit to the last pump and drain, synced); pump ms "
          f"{[round(p, 1) for p in pumps]} (p50 "
          f"{float(np.percentile(pumps, 50)):.1f}, p99 "
          f"{float(np.percentile(pumps, 99)):.1f}); wall split ms {split} "
          f"of {wall_ms:.1f}; device busy {fmt_ms(busy)} ({share} of the "
          f"measured waves, profiler); tail ms "
          f"{ {k: round(v, 1) for k, v in tails.items()} }; "
          f"{res['reader_messages']} messages to {res['readers']} readers, "
          f"{res['summaries_acked']} summaries acked, "
          f"{res['catchup_docs']} catch-up artifacts, "
          f"{res['materialized_docs']} materialized documents, "
          f"{res['promoted']} lanes promoted, no admission nack and no "
          f"fan-out shed; every "
          f"digest equals the JAX golden; {total_s:.1f} s in all; card "
          f"{card}", flush=True)
    figures = {"ops_s": facts["ops"] / facts["wall_s"],
               "pump_p50": float(np.percentile(pumps, 50)),
               "pump_p99": float(np.percentile(pumps, 99)),
               "busy_share": None if busy is None else busy / wall_ms}
    return res, figures


def kernel_rows(captured: dict, counts: dict, card: str,
                phase: str) -> list:
    """The kernel rows of phase 17 or 18: each kernel the phase launched,
    held against its plain version at the inputs of its largest launch in
    the phase, with the phase's launches of that kernel and variant."""
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree import pallas_apply as pa
    from fluidframework_tpu_torch.mergetree import pallas_ops
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    rows = []
    for (name, variant), args in sorted(captured.items(),
                                        key=lambda kv: str(kv[0])):
        if name == "summary_len":
            (state,) = args
            b, c = state.length.shape

            def run(state=state):
                return pallas_ops.summary_lengths(state)

            def plain(state=state):
                return pallas_ops.summary_lengths_plain(state)

            plain_ms, want = plain_once(plain)
            r = dict(name=name, variant=variant,
                     launches=counts.get("summary_len", 0),
                     err=max_abs_err([run()], [want]),
                     source="fluidframework_tpu_torch/kernels/csrc/"
                            "summary_len.cu",
                     replaces="fluidframework_tpu/mergetree/"
                              "pallas_ops.py:58",
                     shape=f"{b} x C={c}", bytes=b * (3 * c * 4 + 3 * 4),
                     ops=b * c * 6,
                     device_ms=one_kernel_ms(run, 20, "summary_len_kernel"))
        elif name == "ticket_scan":
            state, ops, join = args
            b, k = state.client_ids.shape
            t = ops.client.shape[-1]

            def run(state=state, ops=ops, join=join):
                return tk.scan_tickets(state, ops, require_join=join)

            def plain(state=state, ops=ops, join=join):
                return tk.scan_tickets_plain(state, ops, join)

            plain_ms, want = plain_once(plain)
            got = run()
            r = dict(name=name, variant=variant, launches=counts.get(
                "ticket_scan", 0), err=max_abs_err(got[0] + got[1],
                                                   want[0] + want[1]),
                source="fluidframework_tpu_torch/kernels/csrc/"
                       "ticket_scan.cu",
                replaces="fluidframework_tpu/server/ticket_kernel.py:192",
                shape=f"{b} x T {t} x K {k}",
                bytes=ticket_scan_bytes(b, t, k, ops.kind is not None),
                ops=ticket_scan_ops(ops, want[1], want[0].overflow, k),
                device_ms=one_kernel_ms(run, 20, "ticket_scan_kernel"))
        elif name == "fused_apply":
            state, ops, runs, extract = args
            b, c = state.length.shape
            k, a = state.overlap_slots, state.anno_slots

            def run(state=state, ops=ops, runs=runs, extract=extract):
                return pa.apply_ops_fused(state, ops, runs=runs,
                                          extract=extract)

            def plain(state=state, ops=ops, runs=runs, extract=extract):
                return pa.apply_ops_fused_plain(state, ops, runs, extract)

            got = run()
            plain_ms, want = plain_once(plain)
            if not extract:
                got, want = (got, ()), (want, ())
            r = dict(name=f"fused_apply_{variant}" if variant != "plain"
                     else name, variant=variant,
                     launches=counts.get(f"fused_apply[{variant}]", 0),
                     err=max_abs_err(got[0] + tuple(got[1]),
                                     want[0] + tuple(want[1])),
                     source="fluidframework_tpu_torch/kernels/csrc/"
                            "fused_apply.cu",
                     replaces="fluidframework_tpu/mergetree/"
                              "pallas_apply.py:462",
                     shape=f"{b} x C={c} x T {ops.steps}",
                     path=pa.launch_geometry(b, c, k, a).path,
                     bytes=fused_apply_bytes(b, c, ops.steps, k, a,
                                             runs is not None, extract),
                     ops=fused_apply_lane_ops(
                         ops.kind.cpu().numpy(),
                         live_slots(state, ops, runs), k, a),
                     device_ms=one_kernel_ms(run, 20, "fused_apply_kernel"))
        else:
            state, ops, runs = args
            b, c = state.length.shape
            k, a = state.overlap_slots, state.anno_slots

            def run(state=state, ops=ops, runs=runs):
                return kernel.scan_apply(state, ops, runs)

            def plain(state=state, ops=ops, runs=runs):
                return kernel.scan_ops_plain(state, ops, True, runs)

            geo = kernel.scan_geometry(b, c, k, a)
            plain_ms, want = plain_once(plain)
            r = dict(name=name, variant=variant,
                     launches=counts.get(f"scan_apply:{geo.path}[{variant}]",
                                         0),
                     err=max_abs_err(run(), want),
                     source="fluidframework_tpu_torch/kernels/csrc/"
                            "scan_apply.cu",
                     replaces="fluidframework_tpu/mergetree/kernel.py:396",
                     shape=f"{b} x C={c} x T {ops.steps}",
                     path=scan_label(geo),
                     bytes=fused_apply_bytes(b, c, ops.steps, k, a,
                                             runs is not None, False),
                     ops=fused_apply_lane_ops(
                         ops.kind.cpu().numpy(),
                         live_slots(state, ops, runs), k, a),
                     device_ms=long_kernel_ms(run, PATH_REPS)[0])
        r.update(on_main_path=True, ms=ms_of(run, 20),
                 plain_ms=plain_ms, library_ms=None)
        require(r["err"] == 0, f"{phase}: {name}[{variant}] at "
                f"{r['shape']}: the kernel differs from its plain version")
        bound = max(r["bytes"] / PEAK_BYTES_PER_S,
                    r["ops"] / PEAK_OPS_PER_S) * 1e3
        print(f"{phase} kernel: {name}[{variant}] at its largest launch's "
              f"inputs [{r['shape']}]{' ' + r['path'] if 'path' in r else ''}"
              f": {fmt_ms(r['device_ms'])} device, {r['ms']:.4f} ms back "
              f"to back, plain {r['plain_ms']:.3f} ms, bound {bound:.5f} "
              f"ms; {r['launches']} launches in the phase; max_abs_err "
              f"{r['err']}; card {card}", flush=True)
        rows.append(r)
    return rows


def server_phase(dev, card: str, twins: dict = None) -> list:
    """Phase 17, the local server (server/local_server.TpuLocalServer) on
    the card through testing/server_runs.py at golden.SERVER_CARD (512
    documents x 32 inserts a wave in boxcars of 8, map and counter
    traffic, a storm document, readers, summaries, a restart of the
    ingest tier, catch-up and materialized snapshots; 2 partitions, 2
    broadcaster shards), bucketed and paged. The kernel counts are set to
    0 at the start; the server must launch the ticket scan and the scan
    apply, each layout's launches are printed and must add up to the
    phase's; both layouts are held to the JAX golden and to the port's
    CPU twin (a child process per layout, started while phase 16 waited
    for its own)."""
    from fluidframework_tpu_torch.testing import golden

    t_phase = time.perf_counter()
    g = golden.load_server()["card"]
    if not twins:  # main starts them while phase 16 waits
        twins = start_server_twins()
    captured, restore = capture_largest_launches()
    try:
        reset_lambda_counts()
        parts, card_res, figures = {}, {}, {}
        try:
            for layout in ("bucketed", "paged"):
                launched = lambda_counts()
                card_res[layout], figures[layout] = server_layout(
                    dev, card, layout, g[layout])
                figures[layout]["digests"] = card_res[layout]
                parts[layout] = counts_since(launched)
        finally:
            restore()
        counts = lambda_counts()
        # The server's log carries decoded boxcars, so the lambda takes
        # its object path (handler), whose windows apply through the lane
        # stores' scan apply; the fused apply serves only the raw-wire
        # path (handler_raw, phase 16).
        require(counts["ticket_scan"] > 0 and counts["scan_apply"] > 0,
                f"phase 17: the local server did not launch the ticket "
                f"scan and the scan apply: {counts}")
        summed = {k: sum(p.get(k, 0) for p in parts.values())
                  for k in counts}
        require(summed == counts, f"phase 17: the layouts' launches "
                f"{parts} do not add up to the phase's {counts}")
        for layout, part in parts.items():
            print(f"phase 17 {layout}: kernel launches {part} (ticket_scan "
                  f"{part.get('ticket_scan', 0)}, scan_apply "
                  f"{part.get('scan_apply', 0)}, fused_apply "
                  f"{part.get('fused_apply', 0)})", flush=True)
        print(f"phase 17: the local server's kernel launches, both layouts "
              f"(counts from 0 at the phase's start) {counts}", flush=True)
        rows = kernel_rows(captured, counts, card, "phase 17")

        t0 = time.perf_counter()
        for layout, proc in twins.items():
            text, _ = proc.communicate(timeout=SERVER_CPU_TIMEOUT)
            require(proc.returncode == 0, f"phase 17: the {layout} CPU twin "
                    f"exited {proc.returncode}")
            twin = json.loads(text.strip().splitlines()[-1])
            for key in card_res[layout]:
                require(twin[key] == card_res[layout][key],
                        f"phase 17 {layout}: {key} differs between the card "
                        f"and the CPU twin")
            print(f"phase 17 {layout}: the card equals the CPU twin "
                  f"({twin['seconds']:.1f} s in its process; waited "
                  f"{time.perf_counter() - t0:.1f} s after the card)",
                  flush=True)
    finally:
        stop_twins(twins.values())
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, figures


# -- phase 18: the operator's surface ----------------------------------------

# (documents, ops a document a wave, waves) of the decay probe's second run:
# the serving-ingest fleet's widths (bench.py:112, as phase 16 a) over the
# tool's 40 waves.
DECAY_FLEET = (4_096, 32, 40)
DECAY_BUSY_WAVES = 10      # the fleet run's waves under the profiler
# Phase 10's cells of at least this many int32 elements have their tables
# drawn during the kernel build, beside phase 18 (c)'s fleet waves
# (start_set_up): host set-up moved into the build's idle wall.
SCAN_EARLY_INTS = 2**26


def start_set_up(pool: ThreadPoolExecutor) -> dict:
    """Host set-up that needs neither the card nor the kernels, started on
    `pool` before the kernel build: phase 18 (c)'s fleet waves
    (decay_probe.build_wave at DECAY_FLEET) and the tables of phase 10's
    largest cells (scan_tables). Returns their futures ("decay"; "scan",
    by cell)."""
    from fluidframework_tpu_torch.server import decay_probe
    docs, ops, waves = DECAY_FLEET
    out = {"decay": pool.submit(lambda: [decay_probe.build_wave(
        docs, ops, w) for w in range(waves)]), "scan": {}}
    for cell in scan_cells()[0]:
        c, b, a = cell[:3]
        if b * c * (8 + 3 + a) >= SCAN_EARLY_INTS:
            out["scan"][cell] = pool.submit(scan_tables, cell)
    return out


def finish_set_up(futures: dict) -> dict:
    """start_set_up's results, waited for: {"decay": waves, "scan":
    {cell: tables}}."""
    return {"decay": futures["decay"].result(),
            "scan": {cell: f.result() for cell, f in futures["scan"].items()}}
# The op bridge at the north-star shape (bench.py:1056-1058): two sessions,
# three chained partition batches each.
BRIDGE_DOCS, BRIDGE_OPS, BRIDGE_CAPACITY = 10_000, 100, 256
BRIDGE_SESSIONS, BRIDGE_BATCHES = 2, 3
SCRAPE_ROUTES = ("/health", "/metrics.prom", "/trace")
SCRAPE_EVERY_S = 0.1
# /profile windows, one in each of the first two measured waves after the
# first: a short 500 ms window, then the monitor's cap, which spans most of a
# pump and so the sequencer's launches.
PROFILE_MS = (500, 5000)
OPERATOR_CPU_THREADS = 2
OPERATOR_CPU_TIMEOUT = 900
PORT_KERNELS = ("ticket_scan_kernel", "fused_apply_kernel",
                "scan_apply_kernel", "summary_len_kernel")

# The exposition's grammar, as tests/test_prom_conformance.py parses it.
_PROM_VALUE = r'"(?:[^"\\\n]|\\\\|\\"|\\n)*"'
_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*=' + _PROM_VALUE +
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*=' + _PROM_VALUE + r')*\})?'
    r' (-?(?:[0-9.e+-]+|\+Inf|NaN))'
    r'( # \{trace_id=' + _PROM_VALUE + r'\} -?[0-9.e+-]+)?$')


def prom_conformant(text: str) -> int:
    """Check an exposition by tests/test_prom_conformance.py's rules (every
    line parses, HELP and TYPE precede each family's first sample, one
    final EOF and newline, each histogram's buckets cumulative up to +Inf
    == _count); returns the number of samples. One reading differs: a
    sample whose own name carries HELP and TYPE is its own family (the
    gauge fluid_kernel_retrace_count), where the test's parser strips
    every _count suffix and then finds no metadata."""
    lines = text.splitlines()
    require(bool(lines) and lines[-1] == "# EOF" and text.endswith("\n"),
            "exposition: no final '# EOF' line")
    meta, seen, buckets, counts, n = {}, set(), {}, {}, 0
    for line in lines[:-1]:
        require(bool(line) and line != "# EOF",
                "exposition: blank or interior EOF line")
        if line.startswith("#"):
            parts = line.split(None, 3)
            require(len(parts) >= 3 and parts[1] in ("HELP", "TYPE"),
                    f"exposition: bad metadata {line!r}")
            require(parts[2] not in seen,
                    f"exposition: metadata for {parts[2]} after a sample")
            meta.setdefault(parts[2], set()).add(parts[1])
            continue
        m = _PROM_SAMPLE.match(line)
        require(m is not None, f"exposition: unparseable {line!r}")
        metric, labels = m.group(1), m.group(2) or ""
        family = metric if metric in meta else \
            re.sub(r"_(bucket|sum|count)$", "", metric)
        seen.update((metric, family))
        require(meta.get(family) == {"HELP", "TYPE"},
                f"exposition: {family} without HELP and TYPE")
        value = float("inf") if m.group(3) == "+Inf" else float(m.group(3))
        series = (family, re.sub(r',?le="[^"]*"', "", labels))
        if family != metric and metric.endswith("_bucket"):
            buckets.setdefault(series, []).append(value)
        elif family != metric and metric.endswith("_count"):
            counts[series] = value
        n += 1
    for stage, vals in buckets.items():
        require(vals == sorted(vals) and vals[-1] == counts.get(stage),
                f"exposition: buckets of {stage} not cumulative to _count")
    return n


def operator_cpu_main(part: str) -> int:
    """Phase 18's CPU twins, each in a process of its own: "decay", the
    decay probe at golden.DECAY_CARD (prints its lane digest), or
    "server", phase 17's bucketed scenario over the C++ message log
    (prints its digests); one JSON line."""
    from fluidframework_tpu_torch.server import decay_probe
    from fluidframework_tpu_torch.testing import golden, server_runs
    torch.set_num_threads(OPERATOR_CPU_THREADS)
    t0 = time.perf_counter()
    if part == "decay":
        _res, lam, _rates = decay_probe.probe(*golden.DECAY_CARD,
                                              device="cpu")
        out = decay_probe.lane_digest(lam, golden.DECAY_CARD[0])
    else:
        out = server_runs.run(server_runs.port_package("cpu"),
                              server_runs.Spec(**golden.SERVER_CARD),
                              native_log=True)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def start_operator_twin(part: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "operator_cpu_main(sys.argv[1]))", part],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)


def twin_result(proc: subprocess.Popen, what: str) -> dict:
    text, _ = proc.communicate(timeout=OPERATOR_CPU_TIMEOUT)
    require(proc.returncode == 0,
            f"phase 18: the {what} CPU twin exited {proc.returncode}")
    return json.loads(text.strip().splitlines()[-1])


def operator_counts() -> dict:
    """lambda_counts() and the summary length's launches."""
    from fluidframework_tpu_torch.mergetree import pallas_ops
    got = lambda_counts()
    got["summary_len"] = pallas_ops.summary_lengths.launches
    return got


def operator_counts_since(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in operator_counts().items()
            if n != before.get(k, 0)}


def p50(values) -> float:
    return float(np.percentile(values, 50))


def decay_part(dev, card: str, decay_twin, early: dict) -> None:
    """Phase 18 (c): the decay probe at the tool's default (held to the
    JAX golden and the CPU twin by one lane digest) and at the serving
    fleet's widths (timed, the device's busy share by the profiler; its
    waves built during the kernel build, early["decay"]); the tool's own
    verdict, decayed == False, at both."""
    from fluidframework_tpu_torch.server import decay_probe
    from fluidframework_tpu_torch.testing import golden

    want = golden.load_decay()["card"]
    docs, ops, waves = golden.DECAY_CARD
    res, lam, _rates = decay_probe.probe(docs, ops, waves, device=dev)
    got = decay_probe.lane_digest(lam, docs)
    del lam
    require(got == want["lanes"], f"phase 18 (c): the decay probe's lanes "
            f"{got} differ from the JAX golden {want['lanes']}")
    require(not res["decayed"], f"phase 18 (c): decayed at {docs} x {ops} "
            f"x {waves}: {res}")
    print(f"phase 18 (c): decay probe {docs} x {ops} x {waves}: lanes equal "
          f"the JAX golden ({got['folds']} folds, {got['chars']} "
          f"characters); {res['sustained_ops_per_sec']} ops/s sustained, "
          f"decayed {res['decayed']}; card {card}", flush=True)
    # The profiler runs over the last DECAY_BUSY_WAVES waves only: from
    # the first message of the first of them to the probe's end.
    from fluidframework_tpu_torch.server.tpu_sequencer import \
        TpuSequencerLambda
    docs, ops, waves = DECAY_FLEET
    window, seen = BusyWindow(), [0]
    handler = TpuSequencerLambda.handler_raw

    def counted(self, qm):
        if seen[0] == (waves - DECAY_BUSY_WAVES) * docs:
            window.start()
        seen[0] += 1
        return handler(self, qm)

    TpuSequencerLambda.handler_raw = counted
    try:
        res, lam, rates = decay_probe.probe(*DECAY_FLEET, device=dev,
                                            prebuilt=early.pop("decay"))
    finally:
        TpuSequencerLambda.handler_raw = handler
        started = seen[0] > (waves - DECAY_BUSY_WAVES) * docs
        t0 = time.perf_counter()
        busy = window.stop() if started else None
        trace_ms = (time.perf_counter() - t0) * 1e3
    lanes = decay_probe.lane_digest(lam, docs)
    del lam
    require(not res["decayed"], f"phase 18 (c): decayed at {DECAY_FLEET}: "
            f"{res}")
    wave_ms = [docs * ops / r * 1e3 for r in rates]
    tail = rates[waves // 4:]
    med = sorted(tail)[len(tail) // 2]
    maint = [round(docs * ops / r * 1e3, 1) for r in tail if r < med / 3]
    waves_ms = sum(wave_ms[-DECAY_BUSY_WAVES:])
    share = "not measured" if busy is None else f"{busy / waves_ms:.2%}"
    print(f"phase 18 (c): decay probe at the serving fleet's widths {docs} "
          f"x {ops} x {waves}: {res['sustained_ops_per_sec']} ops/s "
          f"sustained (host clock, each wave synced); fast-wave median "
          f"{res['fast_wave_median_ops_per_sec']} ops/s, first-quartile "
          f"median {res['fast_wave_first_quartile_median']}, last-quartile "
          f"median {res['fast_wave_last_quartile_median']}; "
          f"{res['maintenance_waves']} maintenance waves, ms {maint}; wave "
          f"ms p50 {p50(wave_ms):.1f}; folds {res['folds']}, payload "
          f"compactions {res['payload_compactions']}, blocks aged "
          f"{res['blocks_aged']}, overflow drops {res['overflow_drops']} "
          f"({lanes['chars']} characters); device busy {fmt_ms(busy)} "
          f"over the last {DECAY_BUSY_WAVES} waves ({share} of their "
          f"{waves_ms:.1f} ms, profiler; its trace read in "
          f"{trace_ms:.0f} ms); decayed {res['decayed']}; card {card}",
          flush=True)
    twin = twin_result(decay_twin, "decay probe")
    seconds = twin.pop("seconds")
    require(twin == got, f"phase 18 (c): the card's lanes {got} differ from "
            f"the CPU twin's {twin}")
    print(f"phase 18 (c): the card equals the CPU twin ({seconds:.1f} s in "
          f"its process)", flush=True)


def bridge_batches(session: int) -> list:
    """Three chained north-star batches of one session (each continues the
    last's client and reference sequence numbers)."""
    from fluidframework_tpu_torch.testing.traces import gen_traces
    out = []
    for i in range(BRIDGE_BATCHES):
        cols = gen_traces(BRIDGE_DOCS, BRIDGE_OPS, seed=10 * session + i)
        cols["seq"] = cols["seq"] + i * BRIDGE_OPS
        cols["ref_seq"] = cols["ref_seq"] + i * BRIDGE_OPS
        out.append(cols)
    return out


def bridge_part(dev, card: str) -> None:
    """Phase 18 (d): the op bridge's transport-free core at the north-star
    shape. Two sessions, three chained batches each, interleaved: on one
    bridge each stage timed on its own (decode, the copy to the card, the
    step, the copy back and encode; synced between), on a second the
    whole submit(); every reply byte-equal to encode_reply of the port's
    full_step chained directly on the card (timed by CUDA events). One
    more frame carries the golden north-star step's inputs; its reply
    must equal the JAX outputs."""
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.server import bridge as br
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing import golden

    staged = br.OpBridge(capacity=BRIDGE_CAPACITY, device=dev)
    whole = br.OpBridge(capacity=BRIDGE_CAPACITY, device=dev)
    direct = {s: (tk.make_ticket_state(8, batch=BRIDGE_DOCS, device=dev),
                  make_state(BRIDGE_CAPACITY, 1, batch=BRIDGE_DOCS,
                             device=dev))
              for s in range(BRIDGE_SESSIONS)}
    frames = {s: [br.encode_ops(c) for c in bridge_batches(s)]
              for s in range(BRIDGE_SESSIONS)}
    ms = {k: [] for k in ("decode", "to_card", "step", "reply", "batch",
                          "direct")}
    for i in range(BRIDGE_BATCHES):
        for s in range(BRIDGE_SESSIONS):
            frame, sid = frames[s][i], f"s{s}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _b, _t, cols = br.decode_ops(frame)
            t1 = time.perf_counter()
            raw, ops = staged.to_device(cols)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ticketed, total = staged.step(sid, raw, ops)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            reply = staged.reply(ticketed, total)
            t4 = time.perf_counter()
            for k, a, b in (("decode", t0, t1), ("to_card", t1, t2),
                            ("step", t2, t3), ("reply", t3, t4)):
                ms[k].append((b - a) * 1e3)
            t0 = time.perf_counter()
            reply_whole = whole.submit(sid, frame)
            ms["batch"].append((time.perf_counter() - t0) * 1e3)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            tstate, mstate, d_tk, d_total = pipeline.full_step(
                *direct[s], raw, ops)
            e1.record()
            torch.cuda.synchronize()
            ms["direct"].append(e0.elapsed_time(e1))
            direct[s] = (tstate, mstate)
            want = br.encode_reply(d_tk.seq.cpu().numpy(),
                                   d_tk.min_seq.cpu().numpy(),
                                   d_tk.nacked.cpu().numpy().astype(
                                       np.int32), d_total.cpu().numpy())
            require(reply == want and reply_whole == want,
                    f"phase 18 (d): session {s} batch {i}: the bridge's "
                    f"reply differs from the direct step's")
    require(sorted(staged.sessions) == sorted(whole.sessions) == sorted(
        (f"s{s}", BRIDGE_DOCS) for s in range(BRIDGE_SESSIONS)),
        f"phase 18 (d): sessions {sorted(staged.sessions)}")
    g = golden.load()
    cols = dict(g["step_op"])
    cols["seq"] = g["step_raw"]["client_seq"]
    got = br.decode_reply(br.OpBridge(
        capacity=g["step_min"]["length"].shape[1], device=dev).submit(
        "golden", br.encode_ops(cols)))
    t = g["step_ticketed"]
    require(bool((got["seq"] == t["seq"]).all()
                 and (got["minSeq"] == t["min_seq"]).all()
                 and (got["nack"] == t["nacked"]).all()
                 and (got["totalLen"] == g["step_total"]["total_len"]).all()),
            "phase 18 (d): the golden step's reply differs from the JAX "
            "outputs")
    n = BRIDGE_DOCS * BRIDGE_OPS
    print(f"phase 18 (d): op bridge {BRIDGE_SESSIONS} sessions x "
          f"{BRIDGE_BATCHES} batches of {BRIDGE_DOCS} x {BRIDGE_OPS} at C = "
          f"{BRIDGE_CAPACITY} ({len(frames[0][0]) / 1e6:.1f} MB a request, "
          f"{len(reply) / 1e6:.1f} MB a reply): every reply equals the "
          f"direct chained step's, byte for byte, the golden step's reply "
          f"equals the JAX outputs; p50 ms (host clock, synced): decode "
          f"{p50(ms['decode']):.3f}, copy to the card "
          f"{p50(ms['to_card']):.3f}, step {p50(ms['step']):.3f}, copy "
          f"back + encode {p50(ms['reply']):.3f}, whole submit "
          f"{p50(ms['batch']):.3f} ({n / p50(ms['batch']) * 1e3:.0f} ops/s); "
          f"the direct step {p50(ms['direct']):.3f} ms by events "
          f"({n / p50(ms['direct']) * 1e3:.0f} ops/s); card {card}",
          flush=True)


class ServerWatch:
    """Phase 18 (e): a ServiceMonitor over the local server (local
    server, partitions, read path, admission, each sequencer's merge
    store), a FleetObservatory scraping it, a thread fetching every route
    of SCRAPE_ROUTES each SCRAPE_EVERY_S over HTTP during the measured
    waves, and a /profile of each PROFILE_MS window, the first during
    the second measured wave, the next during the third."""

    def __init__(self, dev):
        self.dev = dev
        self.lat = {r: [] for r in SCRAPE_ROUTES}
        self.errors, self.samples = [], []
        self.profiles = []
        self._stop = threading.Event()
        self._threads = []

    def start(self, server) -> None:
        from fluidframework_tpu_torch.server.monitor import ServiceMonitor
        from fluidframework_tpu_torch.server.observatory import \
            FleetObservatory
        self.mon = ServiceMonitor(device=self.dev)
        self.mon.watch_local_server("server", server)
        self.mon.watch_partitions("ingest", server)
        self.mon.watch_readpath("readpath", server)
        if server.admission is not None:
            self.mon.watch_admission("admission", server.admission)
        for i, lam in enumerate(server.ingest.sequencers()):
            self.mon.watch_summaries(f"summaries.p{i}", lam.merge)
        self.mon.start()
        self.obs = FleetObservatory([{"name": "server", "url":
                                      self.mon.url}], interval_s=1.0)
        self.obs.start()
        self._threads = [threading.Thread(target=self._scrape,
                                          daemon=True)]
        self._threads[0].start()

    def _get(self, path: str):
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(self.mon.url + path,
                                        timeout=30) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def _scrape(self) -> None:
        while not self._stop.is_set():
            for route in SCRAPE_ROUTES:
                t0 = time.perf_counter()
                try:
                    status, body = self._get(route)
                except Exception as exc:  # noqa: BLE001 — reported after
                    self.errors.append((route, repr(exc)))
                    continue
                self.lat[route].append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    self.errors.append((route, status, body[:300]))
                elif route == "/metrics.prom":
                    try:
                        self.samples.append(prom_conformant(body.decode()))
                    except SmokeFailure as exc:
                        self.errors.append((route, str(exc)))
                elif route == "/health" and not json.loads(body)["ok"]:
                    self.errors.append((route, "not ok", body[:300]))
            self._stop.wait(SCRAPE_EVERY_S)

    def _take_profile(self, ms: int) -> None:
        before = operator_counts()
        status, body = self._get(f"/profile?ms={ms}")
        self.profiles.append({"ms": ms, "status": status,
                              "body": json.loads(body),
                              "launches": operator_counts_since(before)})

    def on_wave(self, i: int) -> None:
        if i < len(PROFILE_MS):
            for t in self._threads[1:]:     # one capture at a time
                t.join(timeout=60)
            t = threading.Thread(target=self._take_profile,
                                 args=(PROFILE_MS[i],), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        for t in self._threads[1:]:          # the /profile request
            t.join(timeout=60)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)
            require(not t.is_alive(), "phase 18 (e): a scrape thread hung")
        self.obs.scrape_once()
        self.fleet_health = self.obs.fleet_health()
        self.fleet_samples = prom_conformant(self.obs.fleet_prom())
        self.health = self.mon.health()
        self.obs.stop()
        self.mon.stop()


def profile_kernel_events(profile: dict) -> dict:
    """Kernel events of each port kernel in the /profile capture's Chrome
    trace."""
    body = profile["body"]
    require(profile["status"] == 200 and body.get("ok") and body["files"],
            f"phase 18 (e): /profile failed: {profile}")
    with open(os.path.join(body["dir"], "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {k: sum(1 for e in kernels if k in e.get("name", ""))
           for k in PORT_KERNELS}
    out["all_kernels"] = len(kernels)
    return out


def server_part(dev, card: str, server_twin, fig17: dict) -> None:
    """Phase 18 (e): phase 17's bucketed scenario over the C++ message log
    with the monitor, the observatory and the scraper on it: every digest
    equal to phase 17's bucketed golden and to a CPU twin, every scrape
    200 and conformant, /health ok, the profile's files listed."""
    from fluidframework_tpu_torch.telemetry import counters
    from fluidframework_tpu_torch.testing import golden

    counters.reset_histograms()
    watch = ServerWatch(dev)
    res, fig = server_layout(dev, card, "bucketed",
                             golden.load_server()["card"]["bucketed"],
                             native_log=True, watch=watch,
                             phase="phase 18 (e)")
    require(not watch.errors, f"phase 18 (e): scrapes failed: "
            f"{watch.errors[:3]}")
    require(all(watch.lat[r] for r in SCRAPE_ROUTES) and watch.samples,
            f"phase 18 (e): no scrape of some route: "
            f"{ {r: len(v) for r, v in watch.lat.items()} }")
    require(watch.health["ok"], f"phase 18 (e): /health not ok: "
            f"{ {k: v for k, v in watch.health.items() if k in ('checks', 'slo')} }")
    require(watch.fleet_health["workers"]["server"]["ok"],
            f"phase 18 (e): the observatory saw the server unhealthy: "
            f"{watch.fleet_health['workers']}")
    require(len(watch.profiles) == len(PROFILE_MS),
            f"phase 18 (e): {len(watch.profiles)} profiles taken")
    events = [(p["ms"], profile_kernel_events(p), p["launches"])
              for p in watch.profiles]
    lat = {r: (p50(v), float(np.percentile(v, 99)), len(v))
           for r, v in watch.lat.items()}
    print(f"phase 18 (e): C++ log, watched and scraped, {fig['ops_s']:.0f} "
          f"ops/s, pump p50 {fig['pump_p50']:.1f} p99 {fig['pump_p99']:.1f} "
          f"ms, against phase 17's Python log (this run, unwatched) "
          f"{fig17['ops_s']:.0f} ops/s, p50 {fig17['pump_p50']:.1f} p99 "
          f"{fig17['pump_p99']:.1f} ms; "
          f"scrape ms p50 / p99 (scrapes) "
          f"{ {r: (round(a, 2), round(b, 2), n) for r, (a, b, n) in lat.items()} }"
          f"; every scrape 200, {len(watch.samples)} expositions conformant "
          f"(last {watch.samples[-1]} samples; the observatory's merge "
          f"{watch.fleet_samples}), /health ok; /profile wrote "
          f"{watch.profiles[0]['body']['files']}; by window (ms, the "
          f"trace's kernel events, the launch counters over the whole "
          f"request, its export included) {events}; card {card}",
          flush=True)
    twin = twin_result(server_twin, "C++-log server")
    seconds = twin.pop("seconds")
    for key in res:
        require(twin[key] == res[key], f"phase 18 (e): {key} differs "
                f"between the card and the CPU twin")
    print(f"phase 18 (e): the card equals the CPU twin ({seconds:.1f} s in "
          f"its process)", flush=True)


def operator_phase(dev, card: str, decay_twin, fig17: dict,
                   early: dict) -> list:
    """Phase 18, the operator's surface on the card: (a) the conformance
    tool's --heavy run, (b) the microbench, (c) the decay probe, (d) the
    op bridge at the north-star shape, (e) the monitored local server over
    the C++ message log. The kernel counts are set to 0 at the start and
    read after each part; the parts' launches must add up to the phase's,
    and each part must launch the kernels of its path. The CPU twins:
    the decay probe's was started before phase 17, the server's at the
    start of this phase."""
    from fluidframework_tpu_torch.mergetree import pallas_ops
    from fluidframework_tpu_torch.tools import gpu_conformance, microbench

    t_phase = time.perf_counter()
    server_twin = start_operator_twin("server")
    captured, restore = capture_largest_launches()
    parts, secs = {}, {}
    try:
        reset_lambda_counts()
        pallas_ops.summary_lengths.launches = 0
        try:
            def part(name, fn):
                before = operator_counts()
                t0 = time.perf_counter()
                fn()
                secs[name] = round(time.perf_counter() - t0, 1)
                parts[name] = operator_counts_since(before)

            def conformance():
                rc = gpu_conformance.main(["--heavy"])
                require(rc == 0, f"phase 18 (a): the conformance tool "
                        f"exited {rc}")
                print(f"phase 18 (a): gpu_conformance --heavy: 0; card "
                      f"{card}", flush=True)

            def bench():
                for row in microbench.run_all(2000, with_kernel=True):
                    print(f"phase 18 (b): microbench {row['probe']:24} "
                          f"{row['ops']:>8} ops {row['total_ms']:>10.2f} ms "
                          f"{row['us_per_op']:>10.3f} us/op (host clock, the "
                          f"kernel row synced); card {card}", flush=True)

            part("a", conformance)
            part("b", bench)
            part("c", lambda: decay_part(dev, card, decay_twin, early))
            part("d", lambda: bridge_part(dev, card))
            part("e", lambda: server_part(dev, card, server_twin, fig17))
        finally:
            restore()
        counts = operator_counts()
        for name, need in (("a", ("fused_apply", "scan_apply")),
                           ("b", ("scan_apply",)),
                           ("c", ("ticket_scan", "fused_apply[runs]")),
                           ("d", ("ticket_scan", "fused_apply",
                                  "summary_len")),
                           ("e", ("ticket_scan", "scan_apply"))):
            require(all(parts[name].get(k, 0) > 0 for k in need),
                    f"phase 18 ({name}): launched {parts[name]}, not all "
                    f"of {need}")
            print(f"phase 18 ({name}): kernel launches {parts[name]}",
                  flush=True)
        summed = {k: sum(p.get(k, 0) for p in parts.values())
                  for k in counts}
        require(summed == counts, f"phase 18: the parts' launches {parts} "
                f"do not add up to the phase's {counts}")
        print(f"phase 18: kernel launches (counts from 0 at the phase's "
              f"start) {counts}", flush=True)
        rows = kernel_rows(captured, counts, card, "phase 18")
    finally:
        stop_twins((server_twin, decay_twin))
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s (seconds by "
          f"part {secs})", flush=True)
    return rows


# -- phase 19: the client stack ----------------------------------------------

# The CPU twin of (a): its threads and time limit.
CLIENT_CPU_THREADS = 2
CLIENT_CPU_TIMEOUT = 300
# (b): the reader follows the first READER_LIVE_OPS ops of the trace live,
# then misses the rest. The first multiple of 5,000 at which the cost model
# routes the reader's gap to the card (about 217 live segments there; a
# few dozen suffice by costmodel.py's constants). The writer submits the
# trace's ops in boxcars of TRACE_BOXCAR, pumping every TRACE_PUMP_EVERY.
READER_LIVE_OPS = 5_000
TRACE_BOXCAR = 64
TRACE_PUMP_EVERY = 8


def client_cpu_main() -> int:
    """Phase 19 (a)'s CPU twin in a process of its own: testing/
    client_runs at golden.CLIENT_CARD on the CPU; one JSON line."""
    from fluidframework_tpu_torch.testing import client_runs, golden
    torch.set_num_threads(CLIENT_CPU_THREADS)
    t0 = time.perf_counter()
    out = client_runs.run(client_runs.port_package("cpu"),
                          client_runs.Spec(**golden.CLIENT_CARD))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def client_scenario_part(dev, card: str) -> dict:
    """Phase 19 (a): testing/client_runs at golden.CLIENT_CARD on the
    card (TpuLocalServer and Loader on `dev`; the scenario pins
    FLUID_TPU_FORCE_BULK=1 for its run and restores it), held to the JAX
    golden. Scan-apply launches are counted under MergeTreeClient.
    apply_bulk for each late joiner's catch-up; kinds 1 and 4 must
    launch, the server must launch the ticket scan, the kind-3 readers
    must adopt, and the read tier must swallow nothing."""
    from fluidframework_tpu_torch.testing import client_runs, golden

    want = golden.load_client()["card"]
    before = lambda_counts()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    got, under = client_runs.run_counted(
        client_runs.port_package(dev), client_runs.Spec(**golden.CLIENT_CARD))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - h0
    part = counts_since(before)
    require(os.environ.get("FLUID_TPU_FORCE_BULK") is None,
            "phase 19 (a): the scenario left FLUID_TPU_FORCE_BULK set")
    for key in want:
        require(got[key] == want[key], f"phase 19 (a): {key} differs from "
                f"the JAX golden: {got[key]} vs {want[key]}")
    require(under[1] > 0 and under[4] > 0, f"phase 19 (a): scan-apply "
            f"launches under apply_bulk by late-joiner kind {under}: kinds "
            "1 and 4 must launch")
    require(part.get("ticket_scan", 0) > 0, f"phase 19 (a): no ticket-scan "
            f"launch: {part}")
    require(got["adopted"] > 0 and got["swallowed"] == 0,
            f"phase 19 (a): adopted {got['adopted']}, read-tier swallows "
            f"{got['swallowed']}")
    print(f"phase 19 (a): the client stack at {golden.CLIENT_CARD} on the "
          f"card equals the JAX golden ({got['ops']} sequenced messages, "
          f"{got['waves']} waves; apply_bulk calls by kind "
          f"{got['bulk_applies']}, scan-apply launches under them "
          f"{under}; adopted {got['adopted']:.0f}, swallowed "
          f"{got['swallowed']:.0f}; diverged {got['diverged']}, as in the "
          f"JAX golden); {wall_s:.1f} s; kernel launches {part}; card "
          f"{card}", flush=True)
    return {"result": got, "launches": part, "under_bulk": under,
            "wall_s": wall_s}


def reader_catchup_part(dev, card: str, catchup_ms: float) -> dict:
    """Phase 19 (b), BASELINE config #2 through the loader: the phase 11
    trace (keystroke_trace(100,000, seed=12), one client) submitted as
    channel ops over one Connection in boxcars on a LocalServer (no read
    tier: the reconnect takes the tail path). A reader container
    (Loader on `dev`) follows the first READER_LIVE_OPS ops live, reads
    its text (materializing its body), disconnects, misses the rest and
    reconnects: DeltaManager's catch-up hands the gap to Container.
    _process_bulk, and SharedString.process_bulk_core routes it by the
    cost model (no force) with the reader's own live segments. The route
    must pick the card, apply_bulk must launch the scan apply, and the
    text must equal catchup_golden.json's digest. Prints the reconnect's
    wall split (delta fetch, _process_bulk, apply_bulk, the scan kernel's
    event ms) beside phase 11's device_apply_tail wall, then apply_bulk's
    host stages (catchup's stats) and the garbage collector's pauses in
    the reconnect."""
    import gc
    import hashlib

    from fluidframework_tpu_torch.dds.sequence import SharedString
    from fluidframework_tpu_torch.loader.container import Loader
    from fluidframework_tpu_torch.loader.drivers import local as driver
    from fluidframework_tpu_torch.mergetree import catchup, costmodel, kernel
    from fluidframework_tpu_torch.mergetree.catchup import CHUNK_T
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.protocol.messages import (DocumentMessage,
                                                            MessageType)
    from fluidframework_tpu_torch.server.local_server import LocalServer
    from fluidframework_tpu_torch.testing import client_runs, golden
    from fluidframework_tpu_torch.testing.server_runs import _Cfg
    from fluidframework_tpu_torch.testing.traces import keystroke_trace

    force = os.environ.pop("FLUID_TPU_FORCE_BULK", None)
    g = golden.load_catchup()["full"]
    n_ops, seed, n_clients = g["trace"]
    require(n_clients == 1, "phase 19 (b): the trace must have one client")
    ops = [op for op, *_ in keystroke_trace(n_ops, seed=seed,
                                            n_clients=n_clients)]
    server = LocalServer(auto_pump=False, config=_Cfg(client_runs.config()))
    loader = Loader(driver.LocalDocumentServiceFactory(server), device=dev)
    creator = loader.create_detached("config2")
    creator.runtime.create_datastore("default").create_channel(
        "text", SharedString.TYPE)
    creator.attach()
    server.pump()
    creator.close()  # a live replica would replay every op scalar
    writer = server.connect("config2")
    seen, nacks, csn = [0], [], [0]
    writer.on("op", lambda m: seen.__setitem__(
        0, max(seen[0], m.sequence_number)))
    writer.on("nack", nacks.append)
    server.pump()
    reader = loader.resolve("config2")
    server.pump()
    text = reader.runtime.get_datastore("default").get_channel("text")

    def feed(batch) -> float:
        t0 = time.perf_counter()
        for i in range(0, len(batch), TRACE_BOXCAR):
            msgs = []
            for op in batch[i:i + TRACE_BOXCAR]:
                csn[0] += 1
                msgs.append(DocumentMessage(
                    client_sequence_number=csn[0],
                    reference_sequence_number=seen[0],
                    type=MessageType.OPERATION,
                    contents={"address": "default", "contents": {
                        "address": "text", "contents": op}}))
            writer.submit(msgs)
            if (i // TRACE_BOXCAR) % TRACE_PUMP_EVERY == \
                    TRACE_PUMP_EVERY - 1:
                server.pump()
        server.pump()
        return time.perf_counter() - t0

    live_s = feed(ops[:READER_LIVE_OPS])
    t0 = time.perf_counter()
    text.get_text()  # materializes the body: the deferred ops replay
    materialize_s = time.perf_counter() - t0
    segs = len(text.client.tree.segments)
    rest = n_ops - READER_LIVE_OPS
    scalar_s = rest * (costmodel.SCALAR_BASE_S
                       + costmodel.SCALAR_PER_SEG_S * segs)
    device_s = (-(-rest // CHUNK_T) * costmodel.DEVICE_CHUNK_S
                + rest * costmodel.DEVICE_PER_OP_S)
    wins = costmodel.device_bulk_wins(rest, segs, backend=text.device.type)
    print(f"phase 19 (b): the reader followed the first {READER_LIVE_OPS} "
          f"ops live ({live_s:.1f} s of submit and pump; its body "
          f"materialized in {materialize_s:.2f} s) with {segs} live "
          f"segments; the cost model for its {rest}-op gap: scalar "
          f"{scalar_s:.3f} s against device {device_s:.3f} s x "
          f"{costmodel.HYSTERESIS} -> "
          f"{'device' if wins else 'scalar'}", flush=True)
    require(wins, "phase 19 (b): the cost model routes the reader's gap "
            "scalar")
    reader.delta_manager.disconnect()
    server.pump()
    gap_s = feed(ops[READER_LIVE_OPS:])
    bulk_before = text.bulk_catchup_count
    require(not nacks, f"phase 19 (b): the writer was nacked: {nacks[:3]}")

    times = {"fetch": 0.0, "process_bulk": 0.0, "apply_bulk": 0.0}
    calls = {"apply_bulk": 0, "finished": 0, "launches": 0}
    events, stats, pauses, gc_t0 = [], {}, [], [0.0]
    get, apply_bulk, launch, apply_tail = (
        driver.LocalDeltaStorageService.get, MergeTreeClient.apply_bulk,
        kernel._launch, catchup.device_apply_tail)
    dm = reader.delta_manager
    handler = dm._bulk_handler

    def timed(key, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times[key] += time.perf_counter() - t0
        return wrapped

    def counted_apply(self, tail, *args):
        n0 = kernel.scan_apply.launches
        calls["apply_bulk"] += 1
        try:
            out = apply_bulk(self, tail, *args)
            calls["finished"] += 1
            return out
        finally:
            calls["launches"] += kernel.scan_apply.launches - n0

    def with_stats(*args, **kwargs):
        return apply_tail(*args, stats=stats, **kwargs)

    def gc_timed(phase, info):
        # The collector's pauses inside the reconnect: the host holds
        # every sequenced message of the document as Python objects.
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - gc_t0[0]))

    def evented(state, ops_, runs, geo):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(state, ops_, runs, geo)
        e1.record()
        events.append((e0, e1))
        return out

    driver.LocalDeltaStorageService.get = timed("fetch", get)
    MergeTreeClient.apply_bulk = timed("apply_bulk", counted_apply)
    kernel._launch = evented
    catchup.device_apply_tail = with_stats
    dm._bulk_handler = timed("process_bulk", handler)
    gc.callbacks.append(gc_timed)
    try:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        reader.reconnect()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    finally:
        gc.callbacks.remove(gc_timed)
        (driver.LocalDeltaStorageService.get, MergeTreeClient.apply_bulk,
         kernel._launch, catchup.device_apply_tail) = (
            get, apply_bulk, launch, apply_tail)
        dm._bulk_handler = handler
        if force is not None:
            os.environ["FLUID_TPU_FORCE_BULK"] = force
    server.pump()
    kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
    got = text.get_text()
    sha = hashlib.sha256(got.encode()).hexdigest()
    require(len(got) == g["digest"]["visible_length"]
            and sha == g["digest"]["text_sha256"],
            f"phase 19 (b): the reader's text (length {len(got)}, sha256 "
            f"{sha}) differs from the catch-up golden")
    require(calls["apply_bulk"] > 0 and calls["launches"] > 0,
            f"phase 19 (b): the gap did not reach the kernel: {calls}")
    # A bulk apply that raised after launching would have left the run to
    # the scalar replay: the channel counts only a bulk apply that finished.
    require(text.bulk_catchup_count > bulk_before
            and calls["finished"] == calls["apply_bulk"],
            f"phase 19 (b): the gap was replayed scalar (bulk catch-ups "
            f"{bulk_before} -> {text.bulk_catchup_count}, apply_bulk "
            f"{calls})")
    split = {k: round(v * 1e3, 3) for k, v in times.items()}
    print(f"phase 19 (b): the reconnect caught up {rest} ops in "
          f"{wall_ms:.3f} ms ({rest / (wall_ms / 1e3):.0f} ops/s; host "
          f"clock from connect to the channel at the head, synced): delta "
          f"fetch {split['fetch']} ms, _process_bulk "
          f"{split['process_bulk']} ms, of it apply_bulk "
          f"{split['apply_bulk']} ms ({calls['apply_bulk']} call(s)), of "
          f"it the scan kernel {kernel_ms:.3f} ms by events over "
          f"{calls['launches']} launches; phase 11's device_apply_tail "
          f"of all {n_ops} ops {catchup_ms:.3f} ms in this run; the text "
          f"equals the golden (length {len(got)}); the gap's ops were "
          f"submitted and pumped in {gap_s:.1f} s; card {card}", flush=True)
    host = {k[:-2]: round(v * 1e3, 3) for k, v in stats.items()
            if k.endswith("_s")}
    old = [s for g_, s in pauses if g_ == 2]
    print(f"phase 19 (b): apply_bulk's catch-up by stage, host ms {host}; "
          f"chunks {stats.get('chunks')}, folds {stats.get('folds', 0)}, "
          f"retries {stats.get('retries', 0)}; the garbage collector "
          f"paused {len(pauses)} times for "
          f"{sum(s for _, s in pauses) * 1e3:.3f} ms in the reconnect, "
          f"{len(old)} full collections for {sum(old) * 1e3:.3f} ms; card "
          f"{card}", flush=True)
    return {"wall_ms": wall_ms, "split_ms": split, "kernel_ms": kernel_ms,
            "calls": calls, "segments": segs}


def start_client_twin() -> subprocess.Popen:
    """Phase 19 (a)'s CPU twin (client_cpu_main), started with phase 18 so
    that it is done when phase 19 reads it, before (b)'s timed reconnect."""
    return subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "client_cpu_main())"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)


def retime_catchup(dev, card: str, catchup_ms: float) -> float:
    """Phase 11's device_apply_tail of the whole trace, timed once more
    here, with no CPU twin running: the quiet-host figure that (b)'s
    reconnect is compared with. Outside the counted window."""
    from fluidframework_tpu_torch.mergetree import catchup
    from fluidframework_tpu_torch.testing import golden
    from fluidframework_tpu_torch.testing.traces import keystroke_trace

    n_ops, seed, n_clients = golden.load_catchup()["full"]["trace"]
    tail = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    catchup.device_apply_tail([], tail, 0, 0, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - h0) * 1e3
    print(f"phase 19: device_apply_tail of all {n_ops} ops again, no CPU "
          f"twin running: {ms:.3f} ms (phase 11's, beside phase 15's "
          f"twins: {catchup_ms:.3f} ms); card {card}", flush=True)
    return ms


def client_phase(dev, card: str, catchup_ms: float,
                 twin: subprocess.Popen) -> list:
    """Phase 19, the client stack on the card: (a) client_scenario_part,
    held also to its CPU twin (started with phase 18) and collected
    before (b), so that (b) runs on a quiet host; then (b)
    reader_catchup_part and retime_catchup. The kernel counts are set to
    0 at the start; the kernel rows are the largest launch of each kernel
    in (a) and in (b) (the catch-up's chunk shape), with each part's
    launches."""
    t_phase = time.perf_counter()
    rows = []
    try:
        reset_lambda_counts()
        captured, restore = capture_largest_launches()
        try:
            a = client_scenario_part(dev, card)
        finally:
            restore()
        rows += kernel_rows(captured, a["launches"], card, "phase 19 (a)")
        t0 = time.perf_counter()
        text, _ = twin.communicate(timeout=CLIENT_CPU_TIMEOUT)
        require(twin.returncode == 0,
                f"phase 19: the CPU twin exited {twin.returncode}")
        got = json.loads(text.strip().splitlines()[-1])
        for key, value in a["result"].items():
            require(got[key] == value, f"phase 19 (a): {key} differs "
                    f"between the card and the CPU twin")
        print(f"phase 19 (a): the card equals the CPU twin "
              f"({got['seconds']:.1f} s in its process; waited "
              f"{time.perf_counter() - t0:.1f} s after (a))", flush=True)
    finally:
        stop_twins([twin])
    captured, restore = capture_largest_launches()
    before = lambda_counts()
    try:
        reader_catchup_part(dev, card, catchup_ms)
    finally:
        restore()
    part_b = counts_since(before)
    print(f"phase 19 (b): kernel launches {part_b}", flush=True)
    rows += kernel_rows(captured, part_b, card, "phase 19 (b)")
    retime_catchup(dev, card, catchup_ms)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


# -- phase 20: the application layer and the offline document path ----------

# (b)'s CPU twin: its threads and time limit.
APP_CPU_THREADS = 2
APP_CPU_TIMEOUT = 300
# (c): the document's name; the trace op before which a reviewer's comment
# comes and goes (testing/app_runs.comment: it ends a reload's lazy
# absorption of the tail; 5,000 ops leave the body ~480 live segments, so
# the cost model routes the rest of the tail to the card, phase 19 b); the
# replay's start, REPLAY_BACK sequence numbers before the capture's last,
# and its snapshot frequency (two snapshot points past the start); the ops
# the merge-tree client replay takes.
OFFLINE_DOC = "config2"
OFFLINE_COMMENT_AT = 5_000
REPLAY_BACK = 8_000
REPLAY_SNAP = 5_000
MERGETREE_REPLAY_OPS = 5_000
PHASE20_BUDGET_S = 90.0


def app_cpu_main() -> int:
    """Phase 20 (b)'s CPU twin in a process of its own: testing/app_runs on
    the CPU; one JSON line."""
    from fluidframework_tpu_torch.testing import app_runs
    torch.set_num_threads(APP_CPU_THREADS)
    t0 = time.perf_counter()
    out = app_runs.run(app_runs.port_package("cpu"))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def start_app_twin() -> subprocess.Popen:
    """Phase 20 (b)'s CPU twin (app_cpu_main), started with phase 18 beside
    phase 19 (a)'s, so that it is done before phase 19 (b)."""
    return subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "app_cpu_main())"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)


def corpora_part(dev, card: str) -> dict:
    """Phase 20 (a): the four recorded corpora under tests/corpus/ replayed
    by testing/corpus.replay_digest on `dev` against tests/corpus/pins.json;
    the keystroke corpus through MergeTreeClient.apply_bulk on `dev`
    (counted scan-apply launches) against its scalar replay; the snapshot
    corpus's digests on `dev` against tests/snapshots/pinned.json."""
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.testing import corpus, snapshot_corpus

    t0 = time.perf_counter()
    pins = corpus.load_pins()
    for name, pin in sorted(pins.items()):
        got = corpus.replay_digest(os.path.join(corpus.CORPUS_DIR,
                                                pin["file"]), device=dev)
        require(got == pin["digest"], f"phase 20 (a): the {name} corpus "
                f"replays to {got}, pinned {pin['digest']}")
    header, rows = corpus.read_corpus(os.path.join(
        corpus.CORPUS_DIR, pins["keystroke"]["file"]))
    scalar = corpus.replay(header, rows, device=dev).get_text()
    tail = [(contents, seq, ref, ordinal, msn or 0)
            for contents, seq, ref, ordinal, msn
            in corpus.channel_ops(header, rows)]
    bulk = MergeTreeClient(client_id=999, device=dev)
    n0 = kernel.scan_apply.launches
    bulk.apply_bulk(tail)
    torch.cuda.synchronize()
    launched = kernel.scan_apply.launches - n0
    require(launched > 0, "phase 20 (a): the keystroke corpus's apply_bulk "
            "launched no scan apply")
    require(bulk.get_text() == scalar, "phase 20 (a): the keystroke corpus "
            "through apply_bulk differs from its scalar replay")
    with open(snapshot_corpus.PINS_PATH) as f:
        pinned = json.load(f)
    digests = snapshot_corpus.corpus_digests(device=dev)
    require(digests == pinned, f"phase 20 (a): the snapshot corpus's "
            f"digests {digests} differ from tests/snapshots/pinned.json")
    wall_s = time.perf_counter() - t0
    print(f"phase 20 (a): the {len(pins)} corpora equal tests/corpus/"
          f"pins.json on the card ({', '.join(sorted(pins))}); the keystroke "
          f"corpus ({len(tail)} ops) through apply_bulk equals its scalar "
          f"replay, {launched} scan-apply launches; the {len(digests)} "
          f"snapshot digests equal tests/snapshots/pinned.json; {wall_s:.1f} "
          f"s; card {card}", flush=True)
    return {"launches": launched, "wall_s": wall_s}


def app_part(dev, card: str, twin: subprocess.Popen) -> dict:
    """Phase 20 (b): testing/app_runs on the card (TpuLocalServer, BaseHost,
    CodeLoader, the framework, client_api, fetch, the file driver, the
    replay tool), held to app_golden.json and to its CPU twin; scan-apply
    launches under apply_bulk counted for the file driver's reload and the
    replay tool, each above 0."""
    from fluidframework_tpu_torch.testing import app_runs, golden

    want = golden.load_app()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, under = app_runs.run_counted(app_runs.port_package(dev))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    require(os.environ.get("FLUID_TPU_FORCE_BULK") is None,
            "phase 20 (b): the scenario left FLUID_TPU_FORCE_BULK set")
    for key in want:
        require(got[key] == want[key], f"phase 20 (b): {key} differs from "
                f"the JAX golden: {got[key]} vs {want[key]}")
    require(under["file_load"] > 0 and under["replay"] > 0,
            f"phase 20 (b): scan-apply launches under apply_bulk {under}: "
            "the file driver's reload and the replay tool must launch")
    t1 = time.perf_counter()
    try:
        text, _ = twin.communicate(timeout=APP_CPU_TIMEOUT)
    finally:
        stop_twins([twin])
    require(twin.returncode == 0,
            f"phase 20 (b): the CPU twin exited {twin.returncode}")
    cpu = json.loads(text.strip().splitlines()[-1])
    for key, value in got.items():
        require(cpu[key] == value, f"phase 20 (b): {key} differs between "
                "the card and the CPU twin")
    print(f"phase 20 (b): the application scenario on the card equals the "
          f"JAX golden and its CPU twin ({got['ops']} sequenced messages, "
          f"{len(got['snapshots'])} snapshot points, mismatches "
          f"{got['mismatches']}; apply_bulk calls {got['bulk_applies']}, "
          f"scan-apply launches under them {under}); {wall_s:.1f} s (the "
          f"twin {cpu['seconds']:.1f} s in its process, waited "
          f"{time.perf_counter() - t1:.1f} s); card {card}", flush=True)
    return {"under_bulk": under, "wall_s": wall_s}


def offline_part(dev, card: str) -> dict:
    """Phase 20 (c), BASELINE config #2 through the offline document path.

    The document: a BaseHost over the CodeLoader of testing/app_runs
    (ContainerRuntimeFactoryWithDefaultDataStore of its Notes DataObject)
    creates it on a LocalServer; after the attach summary the Notes object
    creates its SharedString live and keeps the handle in its root; one
    writer submits the phase 11 trace (keystroke_trace(100,000, seed=12))
    to it in boxcars of TRACE_BOXCAR over a raw connection, and before op
    OFFLINE_COMMENT_AT a reviewer's container adds a comment and deletes
    it. Then: fetch_document into a temporary directory; a BaseHost over
    FileDocumentServiceFactory reopens the capture on the card (the cost
    model routes, FLUID_TPU_FORCE_BULK unset): its text must equal the
    catch-up golden's digest and the scan apply must launch under
    apply_bulk; ReplayTool.from_capture(..., device).run() from
    REPLAY_BACK before the end with REPLAY_SNAP must be deterministic with
    no mismatch, every straight load (_open) must launch, and the text of
    the last must equal the digest; MergeTreeReplayer over the first
    MERGETREE_REPLAY_OPS text ops of the capture must converge to their
    scalar replay. Prints each step's wall, the file load's split (the
    delta fetch, _process_bulk, apply_bulk, the scan kernel's event ms)
    and the storage checks' lazy materialization per deferred op."""
    import gc
    import hashlib
    import shutil
    import tempfile

    from fluidframework_tpu_torch import framework
    from fluidframework_tpu_torch.dds.sequence import (SharedSegmentSequence,
                                                       SharedString)
    from fluidframework_tpu_torch.hosts import BaseHost
    from fluidframework_tpu_torch.loader.code_loader import CodeLoader
    from fluidframework_tpu_torch.loader.container import Container
    from fluidframework_tpu_torch.loader.drivers import file as file_driver
    from fluidframework_tpu_torch.loader.drivers import local as driver
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.protocol.messages import (DocumentMessage,
                                                            MessageType)
    from fluidframework_tpu_torch.server.local_server import LocalServer
    from fluidframework_tpu_torch.testing import app_runs, client_runs, golden
    from fluidframework_tpu_torch.testing.server_runs import _Cfg
    from fluidframework_tpu_torch.testing.traces import keystroke_trace
    from fluidframework_tpu_torch.tools import (MergeTreeReplayer, ReplayArgs,
                                                ReplayTool, fetch_document)
    from fluidframework_tpu_torch.tools import replay_tool
    from fluidframework_tpu_torch.tools.mergetree_replay import \
        record_from_sequence_ops

    force = os.environ.pop("FLUID_TPU_FORCE_BULK", None)
    g = golden.load_catchup()["full"]
    n_ops, seed, n_clients = g["trace"]
    require(n_clients == 1, "phase 20 (c): the trace must have one client")
    ops = [op for op, *_ in keystroke_trace(n_ops, seed=seed,
                                            n_clients=n_clients)]

    def check_text(got: str, what: str) -> None:
        sha = hashlib.sha256(got.encode()).hexdigest()
        require(len(got) == g["digest"]["visible_length"]
                and sha == g["digest"]["text_sha256"],
                f"phase 20 (c): {what}'s text (length {len(got)}, sha256 "
                f"{sha}) differs from the catch-up golden")

    walls = {}
    tmp = tempfile.mkdtemp(prefix="phase20_")
    try:
        # -- the document ---------------------------------------------------
        t0 = time.perf_counter()
        server = LocalServer(auto_pump=False,
                             config=_Cfg(client_runs.config()))
        factory = driver.LocalDocumentServiceFactory(server)
        code = CodeLoader()
        code.register("notes-app", "1.0.0",
                      framework.ContainerRuntimeFactoryWithDefaultDataStore(
                          framework.DataObjectFactory(
                              "notes", app_runs.notes_class(framework))))
        host = BaseHost(factory, code, app_runs.PACKAGE, device=dev)
        creator = host.initialize_container(OFFLINE_DOC)
        server.pump()
        notes = creator.request("/")
        string = notes.store.create_channel("text", SharedString.TYPE)
        notes.root.set("text", string.handle)
        server.pump()
        creator.close()  # a live replica would replay every op per op
        writer = server.connect(OFFLINE_DOC)
        seen, nacks, csn = [0], [], [0]
        writer.on("op", lambda m: seen.__setitem__(
            0, max(seen[0], m.sequence_number)))
        writer.on("nack", nacks.append)
        server.pump()

        def feed(batch) -> None:
            for i in range(0, len(batch), TRACE_BOXCAR):
                msgs = []
                for op in batch[i:i + TRACE_BOXCAR]:
                    csn[0] += 1
                    msgs.append(DocumentMessage(
                        client_sequence_number=csn[0],
                        reference_sequence_number=seen[0],
                        type=MessageType.OPERATION,
                        contents={"address": "default", "contents": {
                            "address": "text", "contents": op}}))
                writer.submit(msgs)
                if (i // TRACE_BOXCAR) % TRACE_PUMP_EVERY == \
                        TRACE_PUMP_EVERY - 1:
                    server.pump()
            server.pump()

        feed(ops[:OFFLINE_COMMENT_AT])
        reviewer = host.initialize_container(OFFLINE_DOC)
        server.pump()
        app_runs.comment(reviewer.request("/").text(), server)
        reviewer.close()
        server.pump()
        feed(ops[OFFLINE_COMMENT_AT:])
        require(not nacks, f"phase 20 (c): the writer was nacked: "
                f"{nacks[:3]}")
        walls["document"] = time.perf_counter() - t0

        # -- fetch ----------------------------------------------------------
        t0 = time.perf_counter()
        _, fetched, stats = fetch_document(factory, OFFLINE_DOC,
                                           out_dir=f"{tmp}/{OFFLINE_DOC}")
        walls["fetch"] = time.perf_counter() - t0
        sizes = {name: os.path.getsize(f"{tmp}/{OFFLINE_DOC}/{name}")
                 for name in sorted(os.listdir(f"{tmp}/{OFFLINE_DOC}"))}
        print(f"phase 20 (c): the document ({n_ops} trace ops in boxcars of "
              f"{TRACE_BOXCAR}, a comment before op {OFFLINE_COMMENT_AT}) "
              f"built in {walls['document']:.1f} s; fetch_document "
              f"{walls['fetch']:.1f} s: {stats.op_count} messages, seq "
              f"{stats.first_seq}..{stats.last_seq}, by type "
              f"{stats.ops_by_type}, {len(stats.ops_by_client)} senders, "
              f"summary {stats.summary_blob_count} blobs / "
              f"{stats.summary_bytes} bytes; capture files (bytes) {sizes}",
              flush=True)
        # The merge-tree client replay's input: the capture's first text
        # ops, each with its writer's ordinal. Then the server goes: the
        # loads below read the capture alone.
        ordinals, messages = {}, []
        for m in fetched:
            inner = (m.contents or {}).get("contents") \
                if m.type == MessageType.OPERATION and \
                isinstance(m.contents, dict) else None
            if not isinstance(inner, dict) or inner.get("address") != \
                    "text" or inner.get("contents", {}).get("type") not in \
                    (0, 1, 2):
                continue
            d = file_driver.message_to_json(m)
            d["clientOrdinal"] = ordinals.setdefault(m.client_id,
                                                     len(ordinals))
            messages.append(d)
            if len(messages) == MERGETREE_REPLAY_OPS:
                break
        del fetched, server, factory, host, writer

        # -- the file driver's load on the card -----------------------------
        times = {"fetch": 0.0, "stream": 0.0, "process_bulk": 0.0,
                 "apply_bulk": 0.0}
        calls = {"fetch": 0, "apply_bulk": 0, "finished": 0, "launches": 0}
        events, pauses, gc_t0 = [], [], [0.0]
        get, stream, process_bulk, apply_bulk, launch = (
            file_driver.FileDeltaStorage.get,
            file_driver.FileDocumentService.connect_to_delta_stream,
            Container._process_bulk, MergeTreeClient.apply_bulk,
            kernel._launch)

        def gc_timed(phase, info):
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            else:
                pauses.append((info["generation"],
                               time.perf_counter() - gc_t0[0]))

        def timed(key, fn):
            def wrapped(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    times[key] += time.perf_counter() - t
            return wrapped

        def counted_get(self, *args):
            calls["fetch"] += 1
            return get(self, *args)

        def counted_apply(self, tail, *args):
            n0 = kernel.scan_apply.launches
            calls["apply_bulk"] += 1
            try:
                out = apply_bulk(self, tail, *args)
                calls["finished"] += 1
                return out
            finally:
                calls["launches"] += kernel.scan_apply.launches - n0

        def evented(state, ops_, runs, geo):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = launch(state, ops_, runs, geo)
            e1.record()
            events.append((e0, e1))
            return out

        file_driver.FileDeltaStorage.get = timed("fetch", counted_get)
        file_driver.FileDocumentService.connect_to_delta_stream = timed(
            "stream", stream)
        Container._process_bulk = timed("process_bulk", process_bulk)
        MergeTreeClient.apply_bulk = timed("apply_bulk", counted_apply)
        kernel._launch = evented
        gc.callbacks.append(gc_timed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reader = BaseHost(file_driver.FileDocumentServiceFactory(tmp),
                              code, app_runs.PACKAGE, device=dev)
            loaded = reader.initialize_container(OFFLINE_DOC)
            text = loaded.request("/").text()
            torch.cuda.synchronize()
            walls["file_load"] = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(gc_timed)
            (file_driver.FileDeltaStorage.get,
             file_driver.FileDocumentService.connect_to_delta_stream,
             Container._process_bulk, MergeTreeClient.apply_bulk,
             kernel._launch) = (get, stream, process_bulk, apply_bulk,
                                launch)
        kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
        check_text(text.get_text(), "the file driver's load")
        require(calls["launches"] > 0 and text.bulk_catchup_count > 0
                and calls["finished"] == calls["apply_bulk"],
                f"phase 20 (c): the file driver's load did not finish on the "
                f"card: apply_bulk {calls}, bulk catch-ups "
                f"{text.bulk_catchup_count}")
        split = {k: round(v * 1e3, 3) for k, v in times.items()}
        full = [s for g_, s in pauses if g_ == 2]
        print(f"phase 20 (c): the file driver's load (BaseHost over "
              f"FileDocumentServiceFactory, the cost model's route) "
              f"{walls['file_load'] * 1e3:.3f} ms for {stats.op_count} "
              f"messages: the delta fetch {split['fetch']} ms over "
              f"{calls['fetch']} calls (each re-reads ops.json), the "
              f"read-only connection's own read of it {split['stream']} ms, "
              f"the garbage collector {len(pauses)} pauses for "
              f"{sum(s for _, s in pauses) * 1e3:.3f} ms ({len(full)} full "
              f"for {sum(full) * 1e3:.3f} ms), "
              f"_process_bulk {split['process_bulk']} ms, of it apply_bulk "
              f"{split['apply_bulk']} ms ({calls['apply_bulk']} call(s)), of "
              f"it the scan kernel {kernel_ms:.3f} ms by events over "
              f"{calls['launches']} launches; the text equals the catch-up "
              f"golden (length {len(text.get_text())}); card {card}",
              flush=True)
        del loaded, text, reader

        # -- the replay tool on the card ------------------------------------
        # Where each lazy body materializes: in a straight load (at the
        # comment's interval op) or in a storage check (the container
        # loaded from a snapshot, its tail deferred).
        opens, last, where = [], [None], ["run"]
        lazy = {"open": [], "check": [], "run": []}
        tool_open, check, materialize = (
            ReplayTool._open, ReplayTool._validate_from_snapshot,
            SharedSegmentSequence._materialize_body)

        def counted_open(self, replay_to):
            n0 = kernel.scan_apply.launches
            where.append("open")
            try:
                container, controller = tool_open(self, replay_to)
            finally:
                where.pop()
            torch.cuda.synchronize()
            opens.append((replay_to, kernel.scan_apply.launches - n0))
            if replay_to == end:
                last[0] = container
            return container, controller

        def marked_check(self, *args):
            where.append("check")
            try:
                return check(self, *args)
            finally:
                where.pop()

        def timed_materialize(self):
            deferred = len(self._deferred_remote)
            t = time.perf_counter()
            try:
                return materialize(self)
            finally:
                lazy[where[-1]].append((deferred, time.perf_counter() - t))

        ReplayTool._open = counted_open
        ReplayTool._validate_from_snapshot = marked_check
        SharedSegmentSequence._materialize_body = timed_materialize
        try:
            t0 = time.perf_counter()
            tool = ReplayTool.from_capture(f"{tmp}/{OFFLINE_DOC}",
                                           device=dev)
            end = tool.ops[-1].sequence_number  # read by counted_open
            start = end - REPLAY_BACK
            result = tool.run(ReplayArgs(from_seq=start,
                                         snap_freq=REPLAY_SNAP))
            torch.cuda.synchronize()
            walls["replay"] = time.perf_counter() - t0
        finally:
            ReplayTool._open = tool_open
            ReplayTool._validate_from_snapshot = check
            SharedSegmentSequence._materialize_body = materialize
        require(result.deterministic and not result.mismatches,
                f"phase 20 (c): the replay tool reports {result.mismatches}")
        past = [p.sequence_number for p in result.snapshots]
        require(len(past) >= 2 and min(past) > start, f"phase 20 (c): "
                f"snapshot points {past} past {start}: two or more needed")
        require(opens and all(n > 0 for _, n in opens), f"phase 20 (c): "
                f"every straight load must launch the scan apply: {opens}")
        require(last[0] is not None,
                "phase 20 (c): no straight load reached the end")
        check_text(last[0].runtime.get_datastore("default").get_channel(
            "text").get_text(), "the replay tool's last straight load")
        def per_op(key):
            return (f"{[(d, round(s * 1e3, 3)) for d, s in lazy[key]]} "
                    f"(deferred ops, ms), "
                    + (", ".join(f"{s / d * 1e6:.2f}" for d, s in lazy[key]
                                 if d) or "none") + " µs a deferred op")

        print(f"phase 20 (c): ReplayTool.from_capture(device=card).run("
              f"from_seq={start}, snap_freq={REPLAY_SNAP}) "
              f"{walls['replay']:.1f} s: snapshot points {past}, "
              f"deterministic, no mismatch (canonical form: "
              f"replay_tool.{replay_tool.coalesce_sequences.__name__}); "
              f"straight loads (replay_to, scan-apply launches) {opens}; "
              f"lazy materializations in the straight loads, at the "
              f"comment {per_op('open')}; in the storage checks "
              f"{per_op('check')}; in the live replay {per_op('run')}; the "
              f"last straight load's text equals the catch-up golden; card "
              f"{card}", flush=True)
        del last, tool, result

        # -- the merge-tree client replay -----------------------------------
        t0 = time.perf_counter()
        log = record_from_sequence_ops(messages)
        converged = MergeTreeReplayer().replay(log)
        oracle = MergeTreeClient(client_id=-1)
        for seq, op in enumerate(ops[:MERGETREE_REPLAY_OPS], 1):
            oracle.apply_msg(op, seq, seq - 1, 0)
        require(len(log) == MERGETREE_REPLAY_OPS
                and converged == oracle.get_text(),
                f"phase 20 (c): the merge-tree client replay of "
                f"{len(log)} ops converged to a text that differs from "
                f"the trace's first {MERGETREE_REPLAY_OPS} ops")
        walls["mergetree_replay"] = time.perf_counter() - t0
        print(f"phase 20 (c): MergeTreeReplayer over the capture's first "
              f"{len(log)} text ops ({len(ordinals)} writer(s) and an "
              f"observer) converged to the trace's text (length "
              f"{len(converged)}) in {walls['mergetree_replay']:.1f} s; "
              f"walls (s) { {k: round(v, 1) for k, v in walls.items()} }; "
              f"card {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if force is not None:
            os.environ["FLUID_TPU_FORCE_BULK"] = force
    return {"walls": walls, "split_ms": split, "kernel_ms": kernel_ms,
            "calls": calls, "opens": opens, "lazy": lazy}


def offline_phase(dev, card: str, twin: subprocess.Popen) -> list:
    """Phase 20, the application layer and the offline document path on
    the card: (a) corpora_part, (b) app_part (held to its CPU twin,
    started with phase 18), (c) offline_part. The kernel counts are set to
    0 at the start and read at the end: the scan apply (all three parts)
    and the ticket scan ((b)'s TpuLocalServer) must have launched. The
    kernel rows are each kernel's largest launch in the phase, with the
    phase's launches; the phase must finish within PHASE20_BUDGET_S."""
    t_phase = time.perf_counter()
    reset_lambda_counts()
    captured, restore = capture_largest_launches()
    parts = {}
    try:
        before = lambda_counts()
        corpora_part(dev, card)
        parts["a"] = counts_since(before)
        before = lambda_counts()
        app_part(dev, card, twin)
        parts["b"] = counts_since(before)
        before = lambda_counts()
        offline_part(dev, card)
        parts["c"] = counts_since(before)
    finally:
        restore()
        stop_twins([twin])
    counts = lambda_counts()
    phase_s = time.perf_counter() - t_phase
    print(f"phase 20: kernel launches by part {parts}; {phase_s:.1f} s",
          flush=True)
    require(counts.get("scan_apply", 0) > 0
            and counts.get("ticket_scan", 0) > 0,
            f"phase 20: the scan apply and the ticket scan must launch: "
            f"{counts}")
    require(phase_s <= PHASE20_BUDGET_S, f"phase 20 took {phase_s:.1f} s, "
            f"over its {PHASE20_BUDGET_S:.0f} s")
    return kernel_rows(captured, counts, card, "phase 20")

# -- phase 21: the server services -------------------------------------------

# (a): the document's name, the trace's length and the ops the reader
# follows live: BASELINE config #2's 100,000-op keystroke trace (phase
# 11's) cut to its first 30,000 ops, the reader missing 90% of them, so
# that the writer's feed over the socket (1,600-2,800 ops/s on an H100
# host, PERF.md §4) fits the script's time limit; the cost model still
# routes the gap to the card (27,000 ops at the ~190 live segments of the
# first 3,000); the writer's boxcars are TRACE_BOXCAR ops, as in phase 19
# (b).
# (b): the CPU twin's threads and time limit. (c): the fleet the in-process
# worker is fed (testing/deploy_runs.Spec fields; PERF.md §4 lists the cut
# from phase 17's 512 documents) and the deadline for a service process to
# listen. The whole phase must finish within PHASE21_BUDGET_S.
NETWORK_DOC = "config2"
NETWORK_OPS = 30_000
NETWORK_LIVE_OPS = 3_000
CLUSTER_CPU_THREADS = 2
CLUSTER_CPU_TIMEOUT = 300
SERVICE_LISTEN_S = 60.0
PHASE21_BUDGET_S = 120.0


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def wait_until(predicate, deadline_s: float, what: str,
               interval: float = 0.01) -> None:
    """Poll `predicate` until it holds; raise SmokeFailure naming `what`
    after `deadline_s`."""
    end = time.perf_counter() + deadline_s
    while not predicate():
        if time.perf_counter() > end:
            raise SmokeFailure(f"{what}: not within {deadline_s:.0f} s")
        time.sleep(interval)


def network_reconnect_part(dev, card: str, n_ops: int = NETWORK_OPS,
                           live: int = NETWORK_LIVE_OPS) -> dict:
    """Phase 21 (a), BASELINE config #2 over real sockets: the port's
    Tinylicious (alfred's REST and websocket routes over a scalar
    LocalServer) serves one document. A writer, a delta connection of the
    routerlicious driver, types the first `n_ops` of the catch-up golden's
    keystroke trace (phase 11's) in boxcars of TRACE_BOXCAR; a reader
    container (Loader on `dev` over NetworkDocumentServiceFactory) follows
    the first `live` ops live (the writer's flights are acked before the
    next is sent, so its refs trail as phase 19 (b)'s do), reads its text,
    disconnects, misses the rest and reconnects: the gap comes back over
    alfred's /deltas route in one JSON body and DeltaManager hands it to
    Container._process_bulk, whose sequence routes it by the cost model.
    The text must equal golden.trace_text of the ops sent (the string
    replay that tests/test_torch_golden.py holds to the golden's digest of
    the whole trace; the digest itself when `n_ops` is the whole trace),
    and the scan apply must launch under apply_bulk. Prints the reconnect's wall split:
    the /deltas fetch, _process_bulk, apply_bulk, the scan kernel's event
    ms."""
    import hashlib

    from fluidframework_tpu_torch.dds.sequence import SharedString
    from fluidframework_tpu_torch.loader.container import Loader
    from fluidframework_tpu_torch.loader.drivers import routerlicious as net
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.protocol.messages import (DocumentMessage,
                                                            MessageType)
    from fluidframework_tpu_torch.server.tinylicious import (DEFAULT_TENANT,
                                                             Tinylicious)
    from fluidframework_tpu_torch.testing import client_runs, golden
    from fluidframework_tpu_torch.testing.server_runs import _Cfg
    from fluidframework_tpu_torch.testing.traces import keystroke_trace

    force = os.environ.pop("FLUID_TPU_FORCE_BULK", None)
    g = golden.load_catchup()["full"]
    full, seed, n_clients = g["trace"]
    trace = keystroke_trace(n_ops, seed=seed, n_clients=n_clients)
    ops = [op for op, *_ in trace]
    t_part = time.perf_counter()
    with Tinylicious(config=_Cfg(client_runs.config())) as server:
        factory = net.NetworkDocumentServiceFactory(server.url,
                                                    DEFAULT_TENANT)
        loader = Loader(factory, device=dev)
        creator = loader.create_detached(NETWORK_DOC)
        creator.runtime.create_datastore("default").create_channel(
            "text", SharedString.TYPE)
        creator.attach()
        creator.close()  # a live replica would replay every op scalar
        writer = factory.create_document_service(
            NETWORK_DOC).connect_to_delta_stream({})
        # The writer's refs start at the document's head when it joined.
        seen = [writer.checkpoint_sequence_number]
        acked, nacks, csn = [0], [], [0]

        def on_op(m) -> None:
            seen[0] = max(seen[0], m.sequence_number)
            if m.client_id == writer.client_id:
                acked[0] = max(acked[0], m.client_sequence_number)

        writer.on("op", on_op)
        writer.on("nack", nacks.append)
        reader = loader.resolve(NETWORK_DOC)
        text = reader.runtime.get_datastore("default").get_channel("text")
        try:
            def acked_all() -> None:
                want = csn[0]
                # The writer's own ops come back over its socket.
                wait_until(lambda: acked[0] >= want or nacks, 300.0,
                           "phase 21 (a): the writer's ops sequenced")
                require(not nacks, f"phase 21 (a): the writer was nacked: "
                        f"{nacks[:3]}")

            def feed(batch) -> float:
                """Flights of TRACE_PUMP_EVERY boxcars, each sent once the
                one before it is acked: the writer's refs trail by up to
                TRACE_BOXCAR x TRACE_PUMP_EVERY ops, as phase 19 (b)'s
                writer's trail between the server's pumps."""
                t0 = time.perf_counter()
                flight = TRACE_BOXCAR * TRACE_PUMP_EVERY
                for f in range(0, len(batch), flight):
                    ref = seen[0]
                    for i in range(f, min(f + flight, len(batch)),
                                   TRACE_BOXCAR):
                        msgs = []
                        for op in batch[i:i + TRACE_BOXCAR]:
                            csn[0] += 1
                            msgs.append(DocumentMessage(
                                client_sequence_number=csn[0],
                                reference_sequence_number=ref,
                                type=MessageType.OPERATION,
                                contents={"address": "default", "contents": {
                                    "address": "text", "contents": op}}))
                        writer.submit(msgs)
                    acked_all()
                return time.perf_counter() - t0

            live_s = feed(ops[:live])
            wait_until(lambda: reader.delta_manager.last_sequence_number
                       >= seen[0], 60.0,
                       "phase 21 (a): the reader following live")
            text.get_text()  # materializes the body
            reader.delta_manager.disconnect()
            gap_s = feed(ops[live:])
            bulk_before = text.bulk_catchup_count
            times = {"fetch": 0.0, "process_bulk": 0.0, "apply_bulk": 0.0}
            calls = {"apply_bulk": 0, "finished": 0, "launches": 0,
                     "fetches": 0, "rows": 0}
            events = []
            get, apply_bulk, launch = (net.NetworkDeltaStorageService.get,
                                       MergeTreeClient.apply_bulk,
                                       kernel._launch)
            dm = reader.delta_manager
            handler = dm._bulk_handler

            def timed(key, fn):
                def wrapped(*args, **kwargs):
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        times[key] += time.perf_counter() - t0
                return wrapped

            def fetch(self, *args, **kwargs):
                out = get(self, *args, **kwargs)
                calls["fetches"] += 1
                calls["rows"] += len(out)
                return out

            def counted_apply(self, tail, *args):
                n0 = kernel.scan_apply.launches
                calls["apply_bulk"] += 1
                try:
                    out = apply_bulk(self, tail, *args)
                    calls["finished"] += 1
                    return out
                finally:
                    calls["launches"] += kernel.scan_apply.launches - n0

            def evented(state, ops_, runs, geo):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = launch(state, ops_, runs, geo)
                e1.record()
                events.append((e0, e1))
                return out

            net.NetworkDeltaStorageService.get = timed("fetch", fetch)
            MergeTreeClient.apply_bulk = timed("apply_bulk", counted_apply)
            kernel._launch = evented
            dm._bulk_handler = timed("process_bulk", handler)
            head = seen[0]
            try:
                sync(dev)
                h0 = time.perf_counter()
                reader.reconnect()
                wait_until(lambda: dm.last_sequence_number >= head, 300.0,
                           "phase 21 (a): the reader at the head")
                sync(dev)
                wall_ms = (time.perf_counter() - h0) * 1e3
            finally:
                (net.NetworkDeltaStorageService.get,
                 MergeTreeClient.apply_bulk, kernel._launch) = (
                    get, apply_bulk, launch)
                dm._bulk_handler = handler
            got = text.get_text()
        finally:
            reader.close()
            writer.close()
            if force is not None:
                os.environ["FLUID_TPU_FORCE_BULK"] = force
    kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
    sha = hashlib.sha256(got.encode()).hexdigest()
    if n_ops == full:
        require(len(got) == g["digest"]["visible_length"]
                and sha == g["digest"]["text_sha256"],
                f"phase 21 (a): the reader's text (length {len(got)}, "
                f"sha256 {sha}) differs from the catch-up golden")
    require(got == golden.trace_text(trace), f"phase 21 (a): the reader's "
            f"text (length {len(got)}, sha256 {sha}) differs from the "
            f"string replay of the {n_ops} ops sent")
    require(calls["apply_bulk"] > 0 and calls["launches"] > 0
            and calls["finished"] == calls["apply_bulk"]
            and text.bulk_catchup_count > bulk_before,
            f"phase 21 (a): the gap did not finish on the kernel: {calls}")
    rest = n_ops - live
    split = {k: round(v * 1e3, 3) for k, v in times.items()}
    print(f"phase 21 (a): over alfred's sockets, the reader followed "
          f"{live} ops live ({live_s:.1f} s of submit and sequencing), "
          f"missed {rest} ({gap_s:.1f} s) and caught up in {wall_ms:.3f} ms "
          f"({rest / (wall_ms / 1e3):.0f} ops/s; host clock from connect "
          f"to the head, synced): the /deltas fetch {split['fetch']} ms "
          f"({calls['fetches']} call(s), {calls['rows']} rows), "
          f"_process_bulk {split['process_bulk']} ms, of it apply_bulk "
          f"{split['apply_bulk']} ms ({calls['apply_bulk']} call(s)), of it "
          f"the scan kernel {kernel_ms:.3f} ms by events over "
          f"{calls['launches']} launches; the text equals the string "
          f"replay of the {n_ops} ops sent (length {len(got)}); part "
          f"{time.perf_counter() - t_part:.1f} s; card {card}", flush=True)
    return {"wall_ms": wall_ms, "split_ms": split, "kernel_ms": kernel_ms,
            "calls": calls}


def cluster_cpu_main() -> int:
    """Phase 21 (b)'s CPU twin in a process of its own: testing/
    cluster_runs at golden.CLUSTER_CARD on the CPU; one JSON line."""
    from fluidframework_tpu_torch.testing import cluster_runs, golden
    torch.set_num_threads(CLUSTER_CPU_THREADS)
    t0 = time.perf_counter()
    out = cluster_runs.run(cluster_runs.port_package("cpu"),
                           cluster_runs.Spec(**golden.CLUSTER_CARD))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def start_cluster_twin() -> subprocess.Popen:
    """Phase 21 (b)'s CPU twin (cluster_cpu_main)."""
    return subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "cluster_cpu_main())"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)


def cluster_part(dev, card: str) -> dict:
    """Phase 21 (b), a cluster takeover on the device sequencer:
    testing/cluster_runs at golden.CLUSTER_CARD (8 documents x 3 writers
    on three nodes through the cluster driver, Loader and TpuLocalServer
    cores on `dev`): the owner node dies mid-session and node B restores
    each document's core from its checkpoint and rebuilds its lanes from
    the shared deltas. Held to the JAX golden: no seq reused or skipped,
    every operation persisted, every stale client evicted, every text
    equal (writers, late reader, the owner's device lanes). The ticket
    scan and the scan apply must launch."""
    from fluidframework_tpu_torch.testing import cluster_runs, golden

    spec = cluster_runs.Spec(**golden.CLUSTER_CARD)
    want = golden.load_cluster()["card"]
    sync(dev)
    h0 = time.perf_counter()
    got, launches = cluster_runs.run_counted(
        cluster_runs.port_package(dev), spec)
    sync(dev)
    wall_s = time.perf_counter() - h0
    require(os.environ.get("FLUID_TPU_FORCE_BULK") is None,
            "phase 21 (b): the scenario left FLUID_TPU_FORCE_BULK set")
    for key in want:
        require(got[key] == want[key], f"phase 21 (b): {key} differs from "
                f"the JAX golden: {got[key]} vs {want[key]}")
    require(got["contiguous"] == got["agreed"] == spec.docs
            and got["evicted"] == got["stale"]
            and got["op_rows"] == got["typed"],
            f"phase 21 (b): the takeover lost or reused work: {got}")
    require(launches.get("ticket_scan", 0) > 0
            and launches.get("scan_apply", 0) > 0,
            f"phase 21 (b): the ticket scan and the scan apply must "
            f"launch: {launches}")
    print(f"phase 21 (b): the cluster at {golden.CLUSTER_CARD} took over on "
          f"node B and equals the JAX golden ({got['ops']} sequenced "
          f"messages, {got['op_rows']} of {got['typed']} operations "
          f"persisted, seqs contiguous in {got['contiguous']} of "
          f"{spec.docs} documents, {got['evicted']} of {got['stale']} "
          f"stale clients evicted, texts agreeing in {got['agreed']}); "
          f"{wall_s:.1f} s; kernel launches {launches}; card {card}",
          flush=True)
    return {"result": got, "launches": launches, "wall_s": wall_s}


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_service(args, cfg_path: str, cwd: str) -> subprocess.Popen:
    """`python -m fluidframework_tpu_torch.server.main <args> --config
    cfg_path` from this checkout, its output to a file in `cwd`."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    log = open(os.path.join(cwd, f"{args[0]}.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.server.main",
         *args, "--config", cfg_path],
        cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)


def service_output(proc: subprocess.Popen, cwd: str, name: str) -> str:
    with open(os.path.join(cwd, f"{name}.log")) as f:
        return f.read()[-2000:]


def wait_listening(proc, port: int, cwd: str, name: str) -> None:
    import socket

    def up() -> bool:
        if proc.poll() is not None:
            raise SmokeFailure(f"phase 21 (c): the {name} exited "
                               f"{proc.returncode}: "
                               f"{service_output(proc, cwd, name)}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.3).close()
            return True
        except OSError:
            return False

    wait_until(up, SERVICE_LISTEN_S, f"phase 21 (c): the {name} listening",
               interval=0.1)


def stop_services(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def deploy_part(dev, card: str) -> dict:
    """Phase 21 (c), the deployment: the port's `server.main` broker and
    historian (store mode) as processes, and the tpu-deli, scriptorium,
    scribe and copier worker on the card twice: as a spawned `worker`
    process at tests/test_deployment.py's shape (one join and five ops,
    its sqlite deltas checked), and built in this process by build_worker
    against a second broker process, fed testing/deploy_runs at
    golden.DEPLOY_CARD through RemoteMessageLog and held to the JAX
    golden document by document. Records the fleet's ops/s from the
    first send to the last persisted delta (the measured waves), the
    broker's send µs a message and the sequencer lambda's flush p50; the
    ticket scan and the scan apply must launch in this process."""
    import json as _json
    import tempfile

    from fluidframework_tpu_torch.protocol.messages import (Boxcar,
                                                            DocumentMessage,
                                                            MessageType)
    from fluidframework_tpu_torch.server.durable import SqliteDatabaseManager
    from fluidframework_tpu_torch.server.lambdas.scriptorium import (
        delta_key, query_deltas)
    from fluidframework_tpu_torch.server.log_service import RemoteMessageLog
    from fluidframework_tpu_torch.server.main import RAW_TOPIC
    from fluidframework_tpu_torch.server.tpu_sequencer import (
        TpuSequencerLambda)
    from fluidframework_tpu_torch.testing import deploy_runs, golden

    t_part = time.perf_counter()
    before = lambda_counts()
    procs = []
    with tempfile.TemporaryDirectory(prefix="phase21c-") as tmp:
        try:
            port, fleet_port, hist_port = (free_port(), free_port(),
                                           free_port())
            cfg = {
                "broker": {"host": "127.0.0.1", "port": port,
                           "partitions": 1},
                "storage": {"db": os.path.join(tmp, "fluid.sqlite"),
                            "git": os.path.join(tmp, "git")},
                "worker": {"stages": deploy_runs.STAGES, "poll_ms": 5,
                           "tenant": "local"},
                "historian": {"host": "127.0.0.1", "port": hist_port,
                              "url": f"http://127.0.0.1:{hist_port}"},
            }
            cfg_path = os.path.join(tmp, "config.json")
            with open(cfg_path, "w") as f:
                _json.dump(cfg, f)
            fleet_dir = os.path.join(tmp, "fleet")
            os.makedirs(fleet_dir)
            fleet_cfg = os.path.join(fleet_dir, "config.json")
            with open(fleet_cfg, "w") as f:
                _json.dump({"broker": {"host": "127.0.0.1",
                                       "port": fleet_port,
                                       "partitions": 1}}, f)
            broker = spawn_service(["broker"], cfg_path, tmp)
            historian = spawn_service(["historian"], cfg_path, tmp)
            fleet_broker = spawn_service(["broker"], fleet_cfg, fleet_dir)
            procs += [broker, historian, fleet_broker]
            wait_listening(broker, port, tmp, "broker")
            worker = spawn_service(["worker"], cfg_path, tmp)
            procs.append(worker)
            log = RemoteMessageLog(f"127.0.0.1:{port}")
            log.send(RAW_TOPIC, "doc", Boxcar(
                tenant_id="local", document_id="doc", client_id=None,
                contents=[DocumentMessage(
                    client_sequence_number=0, reference_sequence_number=-1,
                    type=MessageType.CLIENT_JOIN,
                    data=_json.dumps({"clientId": "c1", "detail": {}}))]))
            for i in range(1, 6):
                log.send(RAW_TOPIC, "doc", Boxcar(
                    tenant_id="local", document_id="doc", client_id="c1",
                    contents=[DocumentMessage(
                        client_sequence_number=i,
                        reference_sequence_number=0,
                        type=MessageType.OPERATION, contents={"n": i})]))
            log.close()
            db = SqliteDatabaseManager(cfg["storage"]["db"])
            deltas = db.collection("deltas", unique_key=delta_key)
            rows = []

            def persisted() -> bool:
                if worker.poll() is not None:
                    raise SmokeFailure(
                        f"phase 21 (c): the worker exited "
                        f"{worker.returncode}: "
                        f"{service_output(worker, tmp, 'worker')}")
                rows[:] = query_deltas(deltas, "doc")
                return len(rows) >= 6

            spawned_s = time.perf_counter()
            wait_until(persisted, 120.0, "phase 21 (c): the worker "
                       "process's deltas", interval=0.1)
            spawned_s = time.perf_counter() - spawned_s
            db.close()
            seqs = [r["sequence_number"] for r in rows]
            require(seqs == list(range(1, len(seqs) + 1)) and
                    [r["contents"]["n"] for r in rows
                     if r["type"] == MessageType.OPERATION]
                    == [1, 2, 3, 4, 5],
                    f"phase 21 (c): the worker process's deltas {rows}")
            wait_listening(historian, hist_port, tmp, "historian")
            stop_services([worker])
            print(f"phase 21 (c): the worker process (tpu-deli on the "
                  f"card) sequenced and persisted the join and 5 ops "
                  f"{spawned_s:.1f} s after they were sent; the broker "
                  f"and the historian (store mode) are serving", flush=True)

            wait_listening(fleet_broker, fleet_port, fleet_dir,
                           "fleet broker")
            spec = deploy_runs.Spec(**golden.DEPLOY_CARD)
            want = golden.load_deploy()["card"]
            flushes = []
            flush = TpuSequencerLambda.flush

            def timed_flush(self, *args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return flush(self, *args, **kwargs)
                finally:
                    flushes.append(time.perf_counter() - t0)

            TpuSequencerLambda.flush = timed_flush
            try:
                got, timings = deploy_runs.run(
                    deploy_runs.port_package(), spec,
                    f"127.0.0.1:{fleet_port}", fleet_dir, device=str(dev))
            finally:
                TpuSequencerLambda.flush = flush
            sync(dev)
        finally:
            stop_services(procs)
    for key in ("docs", "rows", "ops"):
        require(got[key] == want[key], f"phase 21 (c): {key} {got[key]} "
                f"differs from the JAX golden's {want[key]}")
    differ = [doc for doc, d in want["deltas"].items()
              if got["deltas"].get(doc) != d]
    require(not differ, f"phase 21 (c): the persisted deltas of "
            f"{len(differ)} documents differ from the JAX golden: "
            f"{differ[:5]}")
    measured = slice(spec.warm, None)
    n = sum(timings.messages[measured])
    wall = sum(timings.wall[measured])
    send_us = sum(timings.send[measured]) / n * 1e6
    print(f"phase 21 (c): the in-process worker on the card persisted "
          f"{got['rows']} deltas of {spec.docs} documents, equal to the JAX "
          f"golden document by document; measured waves "
          f"{[round(w, 3) for w in timings.wall[measured]]} s: {n / wall:.1f} "
          f"ops/s from the first send to the last persisted delta, the "
          f"broker's send {send_us:.1f} µs a message, the sequencer's "
          f"flush p50 {p50(flushes) * 1e3:.3f} ms over {len(flushes)} "
          f"flushes; part {time.perf_counter() - t_part:.1f} s; kernel "
          f"launches in this process {counts_since(before)}; card {card}",
          flush=True)
    return {"result": got, "ops_per_s": n / wall, "send_us": send_us,
            "flush_p50_ms": p50(flushes) * 1e3}


def services_phase(dev, card: str) -> list:
    """Phase 21, the server services on the card: (b) cluster_part, held
    also to its CPU twin; (c) deploy_part; then (a)
    network_reconnect_part, with no twin running. The kernel counts are
    set to 0 at the start and read at the end; the kernel rows are each
    kernel's largest launch in the phase, with the phase's launches. The
    phase must finish within PHASE21_BUDGET_S."""
    t_phase = time.perf_counter()
    reset_lambda_counts()
    captured, restore = capture_largest_launches()
    parts = {}
    twin = start_cluster_twin()
    try:
        before = lambda_counts()
        b = cluster_part(dev, card)
        parts["b"] = counts_since(before)
        before = lambda_counts()
        deploy_part(dev, card)
        parts["c"] = counts_since(before)
        require(parts["c"].get("ticket_scan", 0) > 0
                and parts["c"].get("scan_apply", 0) > 0,
                f"phase 21 (c): the ticket scan and the scan apply must "
                f"launch: {parts['c']}")
        t0 = time.perf_counter()
        text, _ = twin.communicate(timeout=CLUSTER_CPU_TIMEOUT)
        require(twin.returncode == 0,
                f"phase 21 (b): the CPU twin exited {twin.returncode}")
        got = json.loads(text.strip().splitlines()[-1])
        seconds = got.pop("seconds")
        require(got == b["result"], "phase 21 (b): the card and the CPU "
                "twin differ")
        print(f"phase 21 (b): the card equals the CPU twin ({seconds:.1f} s "
              f"in its process; waited {time.perf_counter() - t0:.1f} s "
              f"after (c))", flush=True)
        before = lambda_counts()
        network_reconnect_part(dev, card)
        parts["a"] = counts_since(before)
    finally:
        restore()
        stop_twins([twin])
    counts = lambda_counts()
    phase_s = time.perf_counter() - t_phase
    print(f"phase 21: kernel launches by part {parts}; {phase_s:.1f} s",
          flush=True)
    require(phase_s <= PHASE21_BUDGET_S, f"phase 21 took {phase_s:.1f} s, "
            f"over its {PHASE21_BUDGET_S:.0f} s")
    return kernel_rows(captured, counts, card, "phase 21")


# -- phase 22: the capacity grade, the load test, the agents ----------------

CAPACITY_CPU_THREADS = 1
CAPACITY_CPU_TIMEOUT = 900


def capacity_cpu_main() -> int:
    """Phase 22 (a)'s CPU twin in a process of its own: the chaos-on
    capacity grade (testing/capacity_runs.grade at CAPACITY_CARD) through
    the port's TpuLocalServer(device="cpu"); prints the comparable record
    and its seconds as one JSON line."""
    from fluidframework_tpu_torch.testing import capacity_runs
    torch.set_num_threads(CAPACITY_CPU_THREADS)
    t0 = time.perf_counter()
    out = capacity_runs.comparable(capacity_runs.grade(
        capacity_runs.CAPACITY_CARD, device="cpu"))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def start_capacity_twin() -> subprocess.Popen:
    """Phase 22 (a)'s CPU twin (capacity_cpu_main), started before the
    kernel build: it runs beside the build and phases 1-15, whose host is
    busiest before phase 15's twins finish, and is done when phase 22
    reads it. It is killed at exit if it is still running."""
    proc = subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "capacity_cpu_main())"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
    atexit.register(stop_twins, [proc])
    return proc


def first_difference(got, want, path: str = "") -> str:
    """The first key path at which two JSON values differ ("" if none)."""
    if isinstance(got, dict) and isinstance(want, dict):
        for key in sorted(set(got) | set(want), key=str):
            if key not in got or key not in want:
                return f"{path}/{key} (missing on one side)"
            diff = first_difference(got[key], want[key], f"{path}/{key}")
            if diff:
                return diff
        return ""
    if isinstance(got, list) and isinstance(want, list) \
            and len(got) == len(want):
        for i, (a, b) in enumerate(zip(got, want)):
            diff = first_difference(a, b, f"{path}[{i}]")
            if diff:
                return diff
        return ""
    return "" if got == want else f"{path}: {got!r} != {want!r}"


def card_grade(dev) -> dict:
    """Phase 22 (a) on the card: testing/capacity_runs.grade at
    CAPACITY_CARD, chaos on (the grader's probes, then the capacity point
    twice). Every ticket-scan and scan-apply launch is counted by path,
    apart for the launches inside a partition's crash-restart (the
    lambda's recovery), with the stream ms between two CUDA events
    recorded around its wrapper's launch call: the kernel and whatever
    the wrapper queues around it, and the gaps while the host enqueues;
    not the kernel's device time (the kernel rows give that). Returns the
    comparable record, the walls and the launches by path."""
    from collections import defaultdict

    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.server import ticket_kernel as tk
    from fluidframework_tpu_torch.testing import capacity_runs

    where = ["windows"]
    events = defaultdict(list)
    saved = (tk._launch, kernel._launch)

    def evented(name, launch, label):
        def run(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = launch(*args)
            e1.record()
            events[(name, label(args), where[0])].append((e0, e1))
            return out
        return run

    def on_server(server):
        tier = server.ingest
        restart = tier.restart_partition

        def restart_counted(partition):
            where[0] = "recovery"
            try:
                return restart(partition)
            finally:
                where[0] = "windows"
        tier.restart_partition = restart_counted

    tk._launch = evented("ticket_scan", saved[0], lambda a: (
        "kind_require_join" if a[2] else "plain"))
    kernel._launch = evented("scan_apply", saved[1], lambda a: (
        f"{scan_label(a[3])}[{'runs' if a[2] is not None else 'plain'}]"))
    try:
        rec = capacity_runs.grade(capacity_runs.CAPACITY_CARD, device=dev,
                                  on_server=on_server)
        torch.cuda.synchronize()
    finally:
        tk._launch, kernel._launch = saved
    return {"record": capacity_runs.comparable(rec), "wall_s": rec["wall_s"],
            "by_path": {f"{n} {p} ({w})": [len(pairs), round(sum(
                a.elapsed_time(b) for a, b in pairs), 3)]
                for (n, p, w), pairs in sorted(events.items())}}


def capacity_part(dev, card: str, twin: subprocess.Popen) -> tuple:
    """Phase 22 (a): the card grade (card_grade at CAPACITY_CARD, the
    kernel counts set to 0 before it and read after it) held to the JAX
    golden and to the CPU twin, with chaos inside the envelope and both
    kernels launching. Returns the grade's figures, the launch counts and
    the kernel rows (each kernel held against its plain version at its
    largest launch's inputs, timed)."""
    from fluidframework_tpu_torch.testing import capacity_runs, golden

    section = capacity_runs.CAPACITY_CARD
    want = dict(golden.load_capacity()["card"])
    require(want.pop("section") == capacity_runs.comparable(
        {"s": section._asdict()})["s"], "phase 22 (a): the golden's card "
        "section was graded at another shape than CAPACITY_CARD")
    reset_lambda_counts()
    captured, restore = capture_largest_launches()
    try:
        out = card_grade(dev)
    finally:
        restore()
    counts = lambda_counts()
    got, walls, by_path = out["record"], out["wall_s"], out["by_path"]
    require(got == want, "phase 22 (a): the grade differs from the JAX "
            f"golden at {first_difference(got, want)}")
    require(got["fingerprints"][0] == got["fingerprints"][1],
            "phase 22 (a): the capacity point's two runs differ")
    require(got["partition_restarts"] and got["avalanches"] >= 1,
            f"phase 22 (a): no chaos inside the envelope (restarts "
            f"{got['partition_restarts']}, avalanches {got['avalanches']})")
    launched = {n: sum(v[0] for k, v in by_path.items()
                       if k.startswith(n + " "))
                for n in ("ticket_scan", "scan_apply")}
    recovery = sum(v[0] for k, v in by_path.items()
                   if k.endswith("(recovery)"))
    require(launched["ticket_scan"] > 0 and launched["scan_apply"] > 0,
            f"phase 22 (a): the ticket scan and the scan apply must launch: "
            f"{by_path}")
    g = got["grade"]
    docs, ticks = section.workload["documents"], section.fleet["ticks"]
    print(f"phase 22 (a): the capacity grade at {docs} documents x {ticks} "
          f"ticks on the card equals the JAX golden: capacity_mult "
          f"{g['capacity_mult']}, saturated {g['saturated']}, bottleneck "
          f"{g['bottleneck']}, "
          f"probes {[(p['rate_mult'], p['ok']) for p in g['probes']]}; the "
          f"capacity point twice with equal fingerprints "
          f"({got['fingerprints'][0]}), sustained "
          f"{got['final']['sustained_ops_per_sec']} ops/s and "
          f"{got['final']['readers_per_sec']} readers/s (virtual clock), "
          f"partition restarts {got['partition_restarts']}, avalanches "
          f"{got['avalanches']}; wall s: the grade {walls['grade']:.1f}, each"
          f" soak {[round(w, 1) for w in walls['soaks']]}; card {card}",
          flush=True)
    print(f"phase 22 (a): kernel launches and stream ms between CUDA events "
          f"around each launch call (the wrapper's queued work and the "
          f"host's enqueue gaps included: not device time) by path, "
          f"(recovery) inside a partition's crash-restart: {by_path} "
          f"({recovery} recovery launches); card {card}", flush=True)
    rows = kernel_rows(captured, counts, card, "phase 22 (a)")
    t0 = time.perf_counter()
    text, _ = twin.communicate(timeout=CAPACITY_CPU_TIMEOUT)
    require(twin.returncode == 0,
            f"phase 22 (a): the CPU twin exited {twin.returncode}")
    cpu = json.loads(text.strip().splitlines()[-1])
    seconds = cpu.pop("seconds")
    require(cpu == got, "phase 22 (a): the card and the CPU twin differ at "
            f"{first_difference(got, cpu)}")
    print(f"phase 22 (a): the card equals the CPU twin ({seconds:.1f} s in "
          f"its process of {CAPACITY_CPU_THREADS} thread, started before "
          f"the kernel build; waited {time.perf_counter() - t0:.1f} s after "
          f"the card)", flush=True)
    return ({"grade_s": walls["grade"]}, {k: v for k, v in counts.items()
                                          if v}, rows)


def load_agents_part(dev, card: str) -> None:
    """Phase 22 (b), (c), (d): the keystroke load test with reconnect
    churn (testing/client_load_runs.keystroke_load at LOAD_CARD) over
    TpuLocalServer(device=dev), its texts' digest held to the JAX golden
    and the scan apply required to launch; two HeadlessAgentRunners
    hosting the IntelligenceRunner over Loaders on dev, the insights held
    to the JAX golden; the historian smoke on dev."""
    from fluidframework_tpu_torch.testing import client_load_runs as clr
    from fluidframework_tpu_torch.testing import golden, historian_smoke

    g = golden.load_capacity()
    pkg = clr.port_package(dev)
    before = lambda_counts()
    t0 = time.perf_counter()
    got = clr.keystroke_load(pkg, clr.LOAD_CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts_since(before)
    want = dict(g["load"]["card"])
    require(want.pop("profile") == clr.LOAD_CARD, "phase 22 (b): the "
            "golden's load profile is not LOAD_CARD")
    elapsed = got.pop("elapsed_s")
    require(got == want, f"phase 22 (b): the load test differs from the JAX "
            f"golden at {first_difference(got, want)}")
    require(launched.get("scan_apply", 0) > 0,
            f"phase 22 (b): the scan apply never launched: {launched}")
    print(f"phase 22 (b): LoadRunner keystroke trace with reconnect churn "
          f"({clr.LOAD_CARD}) over TpuLocalServer on the card: every replica "
          f"converged, the server's channel text equals every client's, the "
          f"texts ({got['chars']} characters) equal the JAX golden; "
          f"{got['total_ops']} ops in {elapsed:.2f} s of the rig "
          f"({got['total_ops'] / elapsed:.0f} ops/s, host clock), "
          f"{wall:.2f} s in all; kernel launches {launched}; card {card}",
          flush=True)
    before = lambda_counts()
    t0 = time.perf_counter()
    agents = clr.agents_run(pkg)
    torch.cuda.synchronize()
    require(agents == g["agents"], "phase 22 (c): the insights differ from "
            f"the JAX golden at {first_difference(agents, g['agents'])}")
    print(f"phase 22 (c): two HeadlessAgentRunners on Loaders on the card, "
          f"runner {agents['winner']} won the intelligence task alone "
          f"(runs {agents['runs']}), the insights equal the JAX golden "
          f"({sorted(agents['insights'])}); {time.perf_counter() - t0:.2f} s;"
          f" kernel launches {counts_since(before)}; card {card}", flush=True)
    t0 = time.perf_counter()
    rc = historian_smoke.main(device=dev)
    require(rc == 0, f"phase 22 (d): historian_smoke.main exited {rc}")
    print(f"phase 22 (d): historian_smoke.main(device=card) exited 0 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


PACKER_REPS = 5


def packer_part(card: str) -> None:
    """Phase 22 (e): the C op packer (native/src/oppack.cpp) built with g++
    from this checkout, bit-exact to pack_ops_plain over the 8 windows of
    testing/lanes.py's lane fleet at FULL_RING's size (10,000 documents),
    each window's streams packed as the lane stores pack them; both
    packers timed per window (host clock, the best of PACKER_REPS)."""
    from fluidframework_tpu_torch.mergetree import oppack
    from fluidframework_tpu_torch.mergetree.host import OpBuilder
    from fluidframework_tpu_torch.native import build as native_build
    from fluidframework_tpu_torch.testing import lanes, serving

    t0 = time.perf_counter()
    native_build.ensure_built("oppack", force=True)
    oppack._NATIVE_PACK = None
    oppack.native_packer()
    build_s = time.perf_counter() - t0
    fleet = lanes.LaneFleet(serving.FULL_RING, seed=0)
    builder = OpBuilder()
    times = {"c": [], "plain": []}
    n_ops = 0
    for _ in range(serving.FULL_RING.windows):
        merge, _ = fleet.window()
        streams = list(lanes.merge_streams(builder, merge).values())
        n_ops += sum(len(s) for s in streams)
        got = oppack.pack_ops(streams)
        want = oppack.pack_ops_plain(streams)
        for f in oppack.FIELDS:
            require(got[f].dtype == want[f].dtype and
                    np.array_equal(got[f], want[f]),
                    f"phase 22 (e): the C packer differs from pack_ops_plain "
                    f"in {f}")
        for name, fn in (("c", oppack.pack_ops),
                         ("plain", oppack.pack_ops_plain)):
            best = float("inf")
            for _ in range(PACKER_REPS):
                h0 = time.perf_counter()
                fn(streams)
                best = min(best, time.perf_counter() - h0)
            times[name].append(best * 1e3)
    c_ms, plain_ms = sum(times["c"]), sum(times["plain"])
    print(f"phase 22 (e): the C op packer built with g++ in {build_s:.2f} s "
          f"and is bit-exact to pack_ops_plain over {len(times['c'])} lane-"
          f"fleet windows ({len(streams)} documents, {n_ops} merge ops): "
          f"{c_ms:.2f} ms in all ({n_ops / c_ms * 1e3:.0f} ops/s) against "
          f"{plain_ms:.2f} ms for the numpy packer ({plain_ms / c_ms:.1f}x), "
          f"per window ms c {[round(t, 3) for t in times['c']]}, plain "
          f"{[round(t, 3) for t in times['plain']]} (host clock, the best of "
          f"{PACKER_REPS}); card {card}", flush=True)


def capacity_phase(dev, card: str, twin: subprocess.Popen) -> list:
    """Phase 22: the capacity grade (a, on the card and in its CPU twin),
    the load test (b), the agents (c), the historian smoke (d) and the C
    op packer (e). The kernel counts of (a) and of (b)-(d) are each set
    to 0 at the part's start and read at its end; the kernel rows are
    each kernel's largest launch in (a) and in (b)-(d), with that part's
    launches."""
    t_phase = time.perf_counter()
    parts = {}
    try:
        figures, parts["a"], rows = capacity_part(dev, card, twin)
        reset_lambda_counts()
        captured, restore = capture_largest_launches()
        try:
            load_agents_part(dev, card)
        finally:
            restore()
    finally:
        stop_twins([twin])
    parts["b-d"] = {k: v for k, v in lambda_counts().items() if v}
    rows += kernel_rows(captured, parts["b-d"], card, "phase 22 (b-d)")
    packer_part(card)
    print(f"phase 22: kernel launches by part {parts}; the grade "
          f"{figures['grade_s']:.1f} s; {time.perf_counter() - t_phase:.1f} "
          f"s; card {card}", flush=True)
    return rows


# -- phase 23: multi-device ---------------------------------------------------

MESH_DP = 4                      # (a) and (b): a dp mesh of four entries
SP_MESHES = ((1, 8), (2, 4))     # (c): (dp, sp), every entry cuda:0
SP_SHAPE = (2, 48, 4_096, 19)    # (c): tests/test_fused_sp.py's long doc
SP_RICH_SEED = 7                 # (c): the rich schedule's seed
# (b)'s paged layout runs at SERVER_SMALL: at SERVER_CARD both layouts on
# the mesh would take the phase past its 60 s (PERF.md §4 records the cut
# and its reason).
PHASE23_PAGED_SIZE = "small"
# The phase's share of the script's 1,200 s: printed beside the phase's
# wall, not gated (a slower host is not a fault of the path).
PHASE23_BUDGET_S = 60.0


def phase_mesh(dp: int, sp: int = 1):
    """A [dp, sp] mesh: the card's own devices when it has that many,
    else dp * sp entries of cuda:0 (one process drives them all, as the
    JAX package's single controller does)."""
    from fluidframework_tpu_torch.parallel import make_mesh
    n = dp * sp
    if torch.cuda.device_count() >= n:
        return make_mesh(dp=dp, sp=sp)
    return make_mesh(dp=dp, sp=sp, devices=[torch.device("cuda", 0)] * n)


def shard_counts() -> dict:
    from fluidframework_tpu_torch.parallel.mesh import shard_launches
    return {k: dict(sorted(v.items())) for k, v in shard_launches.items()}


def mesh_step_part(dev, card: str, north: dict) -> dict:
    """Phase 23 (a): phase 4's north-star step (DOCS x OPS at C=CAPACITY)
    as full_step over a dp mesh: each shard's 2,500 documents run the
    ticket scan, the fused apply and the summary length on its entry,
    counted per shard from 0; the gathered outputs and state must equal
    phase 4's unsharded step bit for bit. The sharded step's p50 (CUDA
    events, TRIALS from fresh placed state) is printed beside phase 4's,
    and each shard's kernel device ms (torch.profiler)."""
    from fluidframework_tpu_torch.mergetree import pallas_apply, pallas_ops
    from fluidframework_tpu_torch.parallel.mesh import (
        gather, gather_tree, on_shard, reset_shard_launches, shard_docs,
        tree_map)
    from fluidframework_tpu_torch.server import pipeline
    from fluidframework_tpu_torch.server import ticket_kernel as tk

    t_part = time.perf_counter()
    mesh = phase_mesh(MESH_DP)
    raw, ops = north["raw"], north["ops"]

    def placed():
        ts, ms = north["fresh"]()
        return (shard_docs(mesh, ts), shard_docs(mesh, ms),
                shard_docs(mesh, raw), shard_docs(mesh, ops))

    args = placed()
    torch.cuda.synchronize()
    reset_shard_launches()
    out = pipeline.full_step(*args)
    torch.cuda.synchronize()
    per = shard_counts()
    every = {i: 1 for i in range(MESH_DP)}
    for k in ("ticket_scan", "fused_apply", "summary_len"):
        require(per.get(k) == every, f"phase 23 (a): {k} did not launch "
                f"once on each of the {MESH_DP} shards: {per}")
    got = gather_tree(out[:3])
    for what, g, w in zip(("tstate", "mstate", "ticketed"), got,
                          north["out"][:3]):
        assert_tuple_equal(g, w, f"phase 23 (a) {what} vs phase 4")
    require(bool(torch.equal(gather(out[3]), north["out"][3])),
            "phase 23 (a): total_len differs from phase 4's")
    step_ms = []
    for _ in range(TRIALS):
        a = placed()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        pipeline.full_step(*a)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    by_shard = []
    for i in range(MESH_DP):
        ts, ms, r, o = tree_map(lambda x: x.block(i), placed())

        def shard_step():
            _ts, tkd = tk.scan_tickets(ts, r)
            pallas_ops.summary_lengths(pallas_apply.apply_ops_fused(
                ms, pipeline.admit_ops(o, tkd)))

        got = {}
        for _ in range(2):  # a trace that misses a kernel is taken again
            with on_shard(mesh, i):
                trace = kernel_device_ms(shard_step, 3)
            for k in ("ticket_scan", "fused_apply", "summary_len"):
                hits = [ms_ for name, (ms_, _n) in trace.items() if k in name]
                if hits and k not in got:
                    got[k] = round(sum(hits), 4)
            if len(got) == 3:
                break
        by_shard.append({k: got.get(k, "not measured")
                         for k in ("ticket_scan", "fused_apply",
                                   "summary_len")})
    p50 = float(np.median(step_ms))
    print(f"phase 23 (a): full_step {DOCS}x{OPS} C={CAPACITY} over a dp "
          f"mesh of {MESH_DP} ({mesh}): launches per shard {per}; outputs "
          f"and state bit-exact to phase 4's; sharded step p50 {p50:.3f} "
          f"ms ({DOCS * OPS / (p50 / 1e3):.0f} ops/s, trials "
          f"{[round(v, 3) for v in step_ms]}) beside phase 4's "
          f"{north['p50']:.3f} ms; kernel device ms by shard (profiler) "
          f"{by_shard}; "
          f"card {card}", flush=True)
    return {"p50": p50, "per_shard": per, "shard_ms": by_shard,
            "seconds": time.perf_counter() - t_part}


def mesh_server_part(dev, card: str, fig17: dict) -> dict:
    """Phase 23 (b): testing/server_runs on TpuLocalServer(device=dev,
    mesh=<a dp mesh of MESH_DP>), bucketed at SERVER_CARD and paged at
    PHASE23_PAGED_SIZE: every digest equal to the JAX golden's section of
    that size (and, at SERVER_CARD, to phase 17's result in this run),
    testing/shardcheck.verify_store passing on every sequencer after the
    run, and the ticket scan and the scan apply launching on every shard
    (counts from 0 at each layout's start). Prints ops/s (host clock over
    the measured waves, synced) beside phase 17's and the pages copied
    between the pool's shards and the dispatching device."""
    from fluidframework_tpu_torch.mergetree import kernel
    from fluidframework_tpu_torch.parallel.mesh import reset_shard_launches
    from fluidframework_tpu_torch.testing import golden, server_runs
    from fluidframework_tpu_torch.testing import shardcheck

    g = golden.load_server()
    figures = {}
    for layout, size in (("bucketed", "card"),
                         ("paged", PHASE23_PAGED_SIZE)):
        spec = server_runs.Spec(**(golden.SERVER_CARD if size == "card"
                                   else golden.SERVER_SMALL))
        mesh = phase_mesh(MESH_DP)
        servers, facts = [], {}

        def measured(server, run_waves):
            servers.append(server)
            t0 = time.perf_counter()
            facts["ops"] = run_waves()
            torch.cuda.synchronize()
            facts["wall_s"] = time.perf_counter() - t0
            return facts["ops"]

        reset_shard_launches()
        kernel.reset_page_copies()
        t0 = time.perf_counter()
        res = server_runs.run(server_runs.port_package(dev, mesh), spec,
                              hooks={"measured": measured},
                              **server_runs.VARIANTS[layout])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        per = shard_counts()
        want = g[size][layout]
        diff = sorted(k for k in want if res.get(k) != want[k])
        require(not diff, f"phase 23 (b) {layout}: {diff} differ from the "
                f"JAX golden's {size} section")
        same17 = None
        if size == "card" and "digests" in fig17.get(layout, {}):
            same17 = res == fig17[layout]["digests"]
            require(same17, f"phase 23 (b) {layout}: differs from phase "
                    f"17's result in this run")
        checked = sum(shardcheck.verify_store(lam.merge)
                      for lam in servers[0].ingest.sequencers())
        require(checked > 0, f"phase 23 (b) {layout}: verify_store checked "
                f"no leaf")
        for k in ("ticket_scan", "scan_apply"):
            require(sorted(per.get(k, {})) == list(range(MESH_DP)),
                    f"phase 23 (b) {layout}: {k} did not launch on every "
                    f"shard: {per}")
        ops_s = facts["ops"] / facts["wall_s"]
        beside = fig17.get(layout, {}).get("ops_s") if size == "card" \
            else None
        beside = "not run at this size" if beside is None \
            else f"{beside:.0f}"
        pages = (kernel.gather_pages.page_copies,
                 kernel.scatter_pages.page_copies)
        print(f"phase 23 (b) {layout} at {size} ({res['docs']} documents, "
              f"{res['ops']} ops): every digest equals the JAX golden"
              f"{' and phase 17' if same17 else ''}; verify_store checked "
              f"{checked} leaves; launches per shard {per}; {ops_s:.0f} "
              f"ops/s (measured waves, host clock) beside phase 17's "
              f"{beside}; "
              f"pages gathered / scattered between shards and the "
              f"dispatching device {pages[0]} / {pages[1]}; block copies "
              f"{mesh.copies}; {total_s:.1f} s; card {card}", flush=True)
        figures[layout] = {"ops_s": ops_s, "per_shard": per,
                           "page_copies": pages, "seconds": total_s}
    return figures


def mesh_sp_part(dev, card: str) -> dict:
    """Phase 23 (c): a long document with the capacity axis sharded:
    apply_ops_fused_shardmap over SP_MESHES (every entry cuda:0) at
    SP_SHAPE (gen_traces) and on one rich schedule (inserts and removes
    from three clients, gpu_conformance's traces) at the same width, each
    bit-exact to scan_apply.cu's result; then
    gpu_conformance.check_fused_sp. Prints the apply's wall and its
    boundary exchanges per op."""
    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.mergetree import fused_sp, kernel
    from fluidframework_tpu_torch.mergetree.oppack import pack_ops
    from fluidframework_tpu_torch.mergetree.state import make_state
    from fluidframework_tpu_torch.parallel.mesh import gather_tree, make_mesh
    from fluidframework_tpu_torch.testing.traces import gen_traces
    from fluidframework_tpu_torch.tools import gpu_conformance

    b, t, cap, seed = SP_SHAPE
    cases = {
        "gen_traces": interop.packed_ops_from_numpy(
            gen_traces(b, t, seed=seed), dev),
        "rich": interop.packed_ops_from_numpy(
            pack_ops(gpu_conformance._traces(b, t, SP_RICH_SEED)), dev)}
    f = fused_sp.apply_ops_fused_shardmap
    out = {}
    for label, ops in cases.items():
        state = make_state(cap, 2, batch=b, device=dev)
        ref = kernel.scan_apply(state, ops)
        torch.cuda.synchronize()
        k, a = state.overlap_slots, state.anno_slots
        b_ms = fused_apply_bytes(b, cap, t, k, a, False, False) \
            / PEAK_BYTES_PER_S * 1e3
        o_ms = fused_apply_lane_ops(ops.kind.cpu().numpy(),
                                    live_slots(state, ops),
                                    k, a) / PEAK_OPS_PER_S * 1e3
        for dp, sp in SP_MESHES:
            mesh = make_mesh(dp=dp, sp=sp, devices=[dev] * (dp * sp))
            fused_sp.reset_counts()
            t0 = time.perf_counter()
            got = gather_tree(f(state, ops, mesh))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            assert_tuple_equal(got, ref, f"phase 23 (c) {label} dp={dp} "
                               f"sp={sp} vs scan_apply.cu")
            out[(label, dp, sp)] = {"wall_ms": wall,
                                    "exchanges_per_op": f.exchanges / f.ops}
            print(f"phase 23 (c) {label} {b} x {t} ops at C={cap} over "
                  f"dp={dp} sp={sp}: bit-exact to scan_apply.cu; wall "
                  f"{wall:.1f} ms (host clock, synced; the apply is plain "
                  f"torch, no hand kernel) against the fused apply's bound "
                  f"{max(b_ms, o_ms):.5f} ms (by "
                  f"{'bytes' if b_ms >= o_ms else 'operations'}); "
                  f"{f.exchanges} "
                  f"boundary exchanges over {f.ops} op steps "
                  f"({f.exchanges / f.ops:.2f} an op), {f.collectives} "
                  f"collectives, {mesh.copies} block copies; card {card}",
                  flush=True)
    require(gpu_conformance.check_fused_sp(*gpu_conformance.FUSED_SP_SHAPE,
                                           device=dev),
            "phase 23 (c): check_fused_sp failed")
    return out


def mesh_phase(dev, card: str, north: dict, fig17: dict) -> None:
    """Phase 23: the north-star step on a dp mesh (a), the local server
    on a dp mesh (b) and a long document on sp meshes (c), in the main
    process after phase 22 with no child process beside it; its wall is
    printed against PHASE23_BUDGET_S."""
    t_phase = time.perf_counter()
    figures = {"a": mesh_step_part(dev, card, north)}
    figures["b"] = mesh_server_part(dev, card, fig17)
    figures["c"] = mesh_sp_part(dev, card)
    took = time.perf_counter() - t_phase
    print(f"phase 23: {took:.1f} s ((a) {figures['a']['seconds']:.1f}, (b) "
          f"{sum(f['seconds'] for f in figures['b'].values()):.1f}; "
          f"{'within' if took <= PHASE23_BUDGET_S else 'OVER'} its "
          f"{PHASE23_BUDGET_S:.0f} s); card {card}", flush=True)


# -- phase 24: the static gates and the runtime lockset check -------------

# Phase 24 (b): the async-summary overlap's documents and waves (each wave
# three ops a document, testing/ingest.summary_waves), and the phase's
# wall budget.
SUMMARY_DOCS, SUMMARY_WAVES = 64, 6
PHASE24_BUDGET_S = 20.0
GATES_TIMEOUT_S = 600


def gates_main() -> int:
    """Phase 24 (a) in a process of its own: the port's fluidlint over
    fluidframework_tpu_torch/ (its baseline applied, no result cache) and
    its layer check; then (b)'s overlap on the CPU, whose texts the card's
    are held to. Prints one JSON line."""
    from fluidframework_tpu_torch.analysis import Baseline, analyze_paths
    from fluidframework_tpu_torch.tools import layer_check

    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "fluidframework_tpu_torch")
    t0 = time.perf_counter()
    res = analyze_paths([pkg], baseline=Baseline.load())
    lint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    violations = layer_check.check(pkg)
    cycles = layer_check.find_cycles(layer_check.import_graph(pkg))
    layer_s = time.perf_counter() - t0
    from fluidframework_tpu_torch.testing import lambda_runs
    torch.set_num_threads(1)
    cpu = lambda_runs.summary_overlap_run(
        lambda_runs.port_package("cpu"), SUMMARY_DOCS, SUMMARY_WAVES,
        3 * SUMMARY_DOCS)
    print(json.dumps({
        "lint_s": lint_s, "files": res.files,
        "findings": [v.render() for v in res.violations],
        "suppressed": res.suppressed, "baselined": len(res.baselined),
        "race_ms": res.race_rules_wall_ms,
        "placement_ms": res.placement_rules_wall_ms,
        "layer_violations": [str(v) for v in violations],
        "cycles": [" -> ".join(c) for c in cycles],
        "layer_s": layer_s, "cpu_texts": cpu["texts"]}), flush=True)
    return 0


def start_gates_twin() -> subprocess.Popen:
    """gates_main, started before the kernel build: host work alone, so it
    runs in the build's wall and phase 24 reads it. It is killed at exit
    if it is still running."""
    proc = subprocess.Popen(
        [sys.executable, "-c", TWIN_PRELUDE + "sys.exit(chip_smoke."
         "gates_main())"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
    atexit.register(stop_twins, [proc])
    return proc


def lint_lock_phase(dev, card: str, twin: subprocess.Popen) -> None:
    """Phase 24: (a) the gates' child process read back and held; (b) the
    async-summary overlap on the card under the runtime lockset check."""
    from fluidframework_tpu_torch.server.tpu_sequencer import MergeLaneStore
    from fluidframework_tpu_torch.testing import lambda_runs
    from fluidframework_tpu_torch.testing.lockcheck import (instrument,
                                                            static_guards)

    t_phase = time.perf_counter()
    text, _ = twin.communicate(timeout=GATES_TIMEOUT_S)
    require(twin.returncode == 0,
            f"phase 24 (a): the gates' process exited {twin.returncode}")
    g = json.loads(text.strip().splitlines()[-1])
    print(f"phase 24 (a): fluidlint over fluidframework_tpu_torch/: "
          f"{g['lint_s']:.3f} s host wall (race model "
          f"{g['race_ms']:.1f} ms, placement model "
          f"{g['placement_ms']:.1f} ms) beside the kernel build, "
          f"{g['files']} files, {len(g['findings'])} unbaselined "
          f"finding(s), {g['suppressed']} suppressed inline, "
          f"{g['baselined']} baselined; layer check "
          f"{len(g['layer_violations'])} violation(s), "
          f"{len(g['cycles'])} import cycle(s) in {g['layer_s']:.3f} s; "
          f"card {card}", flush=True)
    require(not g["findings"], f"phase 24 (a): unbaselined fluidlint "
            f"findings: {g['findings']}")
    require(not g["layer_violations"] and not g["cycles"],
            f"phase 24 (a): layer check: {g['layer_violations']} "
            f"{g['cycles']}")

    guards = static_guards(MergeLaneStore)
    want = {"_snap_cache": "_guard_lock", "_extract_guards": "_guard_lock",
            "last_summarized_gen": "_guard_lock"}
    require({k: guards.get(k) for k in want} == want,
            f"phase 24 (b): static_guards(MergeLaneStore) is {guards}")
    guards["_deferred_frees"] = "_guard_lock"
    checks = []

    def check(store):
        checks.append(instrument(store, guards))
        return checks[-1]

    pkg = lambda_runs.port_package(dev)
    ops_per_wave = 3 * SUMMARY_DOCS
    reset_lambda_counts()
    wrapped = lambda_runs.summary_overlap_run(
        pkg, SUMMARY_DOCS, SUMMARY_WAVES, ops_per_wave, check=check)
    torch.cuda.synchronize()
    launched = lambda_counts()
    plain = lambda_runs.summary_overlap_run(
        pkg, SUMMARY_DOCS, SUMMARY_WAVES, ops_per_wave)
    require(len(checks) == 1 and not checks[0].violations,
            "phase 24 (b): the lockcheck recorded violations")
    require(launched["ticket_scan"] > 0 and launched["scan_apply"] > 0,
            f"phase 24 (b): the lambda did not launch the ticket scan and "
            f"the scan apply: {launched}")
    require(wrapped["overlapped_flushes"] > 0,
            "phase 24 (b): no flush overlapped a summary worker")
    require(wrapped["texts"] == plain["texts"] == g["cpu_texts"],
            f"phase 24 (b): the texts of the wrapped run, the unwrapped "
            f"run and the CPU run differ: {wrapped['texts']}, "
            f"{plain['texts']}, {g['cpu_texts']}")
    require(len(wrapped["summaries"]) == SUMMARY_WAVES,
            f"phase 24 (b): {wrapped['summaries']} summaries")
    took = time.perf_counter() - t_phase
    print(f"phase 24 (b): {SUMMARY_DOCS} documents x {SUMMARY_WAVES} "
          f"waves of {ops_per_wave} ops on TpuSequencerLambda(cuda), the "
          f"MergeLaneStore under lockcheck with {sorted(guards.items())}: "
          f"assert_clean() held; {wrapped['overlapped_flushes']} flushes "
          f"overlapped a summary worker, summaries {wrapped['summaries']}; "
          f"texts {wrapped['texts']} equal the unwrapped run's and the "
          f"CPU run's; launches "
          f"{launched}; wrapped {wrapped['seconds']:.3f} s, unwrapped "
          f"{plain['seconds']:.3f} s host wall; card {card}", flush=True)
    print(f"phase 24: {took:.1f} s "
          f"({'within' if took <= PHASE24_BUDGET_S else 'OVER'} its "
          f"{PHASE24_BUDGET_S:.0f} s); card {card}", flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main(north_star_only="--north-star" in sys.argv[1:]))
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
