"""The committed golden inputs and JAX outputs (golden/*.npz).

golden/fused_apply_golden.npz holds, as numpy arrays keyed
"<section>.<field>":
  apply_in / apply_op / apply_out   a rich-schedule batch (annotates,
      overlapping removes, pending local ops and acks, a capacity-overflow
      doc and an overlap-overflow doc): DocState in, PackedOps, and the
      JAX package's apply_ops_fused_ref output;
  step_tin / step_min / step_raw / step_op   inputs of one small north-star
      step (with duplicate clientSeqs, so some ops are dropped);
  step_tout / step_mout / step_ticketed / step_total   the JAX package's
      full_step outputs.
golden/serve_megakernel_golden.npz (SERVE_GOLDEN_PATH) holds one small
staged serving ring (testing/serving.py SMALL_RING, page groups of 16-row
pages, INSERT_RUN slots, a mispredicted run, nacks, LWW lanes) and the JAX
package's serve_megakernel_keep outputs with stats on:
  tstate_in / pool_in / lww_in_<i>   the states before the ring;
  ring                               serving.ring_to_arrays of its args;
  tstate_out / pool_out / lww_out_<i> / wire (flat16_k, msn_k) /
  pre_<g>                            the JAX outputs.
golden/catchup_golden.json (CATCHUP_GOLDEN_PATH) holds the JAX package's
bulk catch-up (mergetree/catchup.device_apply_tail from no entries) of two
keystroke traces (testing/traces.keystroke_trace, seed 12, one client):
  small   the 3,000-op prefix: its snapshot entries in full;
  full    the 100,000-op trace: entries_digest of its entries (count,
          visible length, sha256 of the canonical JSON, sha256 of the
          visible text).
golden/extract_golden.npz (EXTRACT_GOLDEN_PATH) and extract_golden.json
(EXTRACT_JSON_PATH) hold the summarize path on one small rich batch
(extract_streams: four documents with annotates, markers, pending rows and
removes in the collab window, an empty one, and one whose live seqs span
more than int16), applied by the JAX package's scan:
  state_in                        the batch's DocState;
  compacted / packed / pre_counts compact_extract_batched(stats=True);
  narrow / wide                   fetch_extracted in both forms;
  wire                            their summarize.bytes_d2h deltas and the
                                  narrow form's summarize.wire_refetch;
and in the .json the payload table (encode_payloads), assemble_snapshot of
EXTRACT_DOCS, and pack_entries_narrow of catchup_golden.json's small
entries at base CATCHUP_BLOB_BASE.
golden/lane_store_golden.npz (LANES_GOLDEN_PATH) and lane_store_golden.json
(LANES_JSON_PATH) hold the JAX package's lane stores (server/
tpu_sequencer.py) driven through testing/lanes.scenario(GOLDEN_SPEC,
GOLDEN_SEED): a bucketed MergeLaneStore with an LwwLaneStore, and a paged
MergeLaneStore, over a small fleet whose run promotes, folds, rescues,
compacts pages and passes a dirty epoch:
  bucket<i> / lww<i> / pool       the final states (the page pool);
and in the .json, per store, testing/lanes.store_results (placements,
texts, entries, recovery counts; LWW snapshots), which hot documents
seeded, both extract_all results and the blob-cache hits.
golden/lambda_golden.json (LAMBDA_GOLDEN_PATH) holds the JAX package's
sequencer lambda (server/tpu_sequencer.TpuSequencerLambda) through the
scenarios of testing/lambda_runs.py, as their digests:
  serving/<bucketed|paged>       serving_run at LAMBDA_SERVING (the
                                 serving-ingest fleet at its full width)
                                 and at LAMBDA_SERVING_SMALL;
  storm/<sync|mega>              storm_run of the ragged storm fleet;
  mixed, mixed_small            mixed_run at LAMBDA_MIXED and at
                                 LAMBDA_MIXED_SMALL.
golden/server_golden.json (SERVER_GOLDEN_PATH) holds the JAX package's
local server (server/local_server.TpuLocalServer) through
testing/server_runs.run, as its digests:
  card/<bucketed|paged>          at SERVER_CARD (512 documents);
  small/<bucketed|paged|overlapped|scalar>
                                 at SERVER_SMALL (the last through
                                 LocalServer, the scalar deli).
golden/client_golden.json (CLIENT_GOLDEN_PATH) holds the JAX package's
client stack (Loader, local driver, runtime and DDSes) on its
TpuLocalServer through testing/client_runs.run, as its digests:
  card                           at CLIENT_CARD;
  small                          at CLIENT_SMALL.
golden/decay_golden.json (DECAY_GOLDEN_PATH) holds the JAX package's
serving decay probe (server/decay_probe.run) as decay_probe.lane_digest
of the lambda it drove (the lane-health counters and every lane's text):
  card                           at DECAY_CARD (the tool's default);
  small                          at DECAY_SMALL (the JAX test's shape).
golden/app_golden.json (APP_GOLDEN_PATH) holds the JAX package's
application layer and offline document path (framework, code loader,
host, client_api, the file driver, the fetch and replay tools) through
testing/app_runs.run, as its digests (one run; app_runs has no size).
golden/cluster_golden.json (CLUSTER_GOLDEN_PATH) holds the JAX package's
multi-node ordering (server/nodes.Cluster with its TpuLocalServer cores,
the cluster driver, the Loader) through a takeover, testing/
cluster_runs.run, as its digests (the run gives the JAX package the
port's per-document checkpoint scoping, ROADMAP Queue 3 item 11):
  card                           at CLUSTER_CARD;
  small                          at CLUSTER_SMALL.
golden/deploy_golden.json (DEPLOY_GOLDEN_PATH) holds the JAX package's
deployment worker (server/main.build_worker with the tpu-deli,
scriptorium, scribe and copier stages over a gRPC broker, durable sqlite
deltas) fed testing/deploy_runs's fleet, as each document's persisted
delta rows' digest:
  card                           at DEPLOY_CARD;
  small                          at DEPLOY_SMALL.
golden/capacity_golden.json (CAPACITY_GOLDEN_PATH) holds the JAX package's
chaos-on capacity grade of a TpuLocalServer fleet, testing/
capacity_runs.grade, as its comparable record (the grade with every
probe's verdict and pressures, both final fingerprints, final_seq and
stream_digests), and the keystroke load test's and the headless agents'
results through testing/client_load_runs:
  card                           at capacity_runs.CAPACITY_CARD;
  small                          at capacity_runs.CAPACITY_SMALL;
  load                           at client_load_runs.LOAD_CARD / _SMALL;
  agents                         client_load_runs.agents_run.
tests/test_torch_golden.py regenerates the files from the JAX package and
requires equality, so the values cannot drift (the lambda golden through
tests/test_torch_lambda_golden.py, the server golden through
tests/test_torch_server_golden.py, the decay golden through
tests/test_torch_tools.py, the app golden through
tests/test_torch_offline_tools.py, the cluster golden through
tests/test_torch_cluster_golden.py, the deploy golden's small section
through tests/test_torch_deploy_golden.py, the capacity golden's small
sections through tests/test_torch_capacity_golden.py); chip_smoke.py
holds the CUDA kernels, the lambda and the local server against them on
a machine without JAX.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().parent / "golden" / \
    "fused_apply_golden.npz"
SERVE_GOLDEN_PATH = GOLDEN_PATH.with_name("serve_megakernel_golden.npz")
CATCHUP_GOLDEN_PATH = GOLDEN_PATH.with_name("catchup_golden.json")
EXTRACT_GOLDEN_PATH = GOLDEN_PATH.with_name("extract_golden.npz")
EXTRACT_JSON_PATH = GOLDEN_PATH.with_name("extract_golden.json")
# The keystroke traces of the catch-up golden: (n_ops, seed, n_clients).
CATCHUP_SMALL = (3000, 12, 1)
CATCHUP_FULL = (100_000, 12, 1)
# The extraction golden's batch: ops per document, capacity, annotate
# slots; the seeds of its rich documents and of the one whose seqs jump by
# EXTRACT_SEQ_GAP; the documents whose snapshots it assembles.
EXTRACT_OPS, EXTRACT_CAPACITY, EXTRACT_ANNO = 48, 128, 4
EXTRACT_SEEDS = (700, 701, 702, 703)
EXTRACT_GAP_SEED, EXTRACT_SEQ_GAP = 716, 40_000
EXTRACT_DOCS = (0, 5)
CATCHUP_BLOB_BASE = 3000
LAMBDA_GOLDEN_PATH = GOLDEN_PATH.with_name("lambda_golden.json")
# (documents, ops a document a wave) of the lambda golden's scenarios.
LAMBDA_SERVING = (4_096, 32)
LAMBDA_SERVING_SMALL = (512, 16)
LAMBDA_MIXED = (1_024, 6)          # documents, waves
LAMBDA_MIXED_SMALL = (160, 6)
SERVER_GOLDEN_PATH = GOLDEN_PATH.with_name("server_golden.json")
# testing/server_runs.Spec fields. The card's fleet keeps the serving-
# ingest traffic's widths (bench.py:112: 32 ops a document a wave in
# boxcars of 8) at 512 documents and 2 warm waves: the local server's
# object path costs tenths of a millisecond a message on the host, and the
# reference's scribe checkpoint and restart delta replay scan whole
# collections (PERF.md §4). The small fleet runs the same traffic in the
# CPU tests (16 documents, 3 waves).
SERVER_CARD = {"docs": 512, "warm": 2}
SERVER_SMALL = {"docs": 16, "warm": 1, "measured": 1, "extra": 1,
                "lww_every": 4, "storm_every": 8, "reader_every": 4,
                "summary_every": 4, "catchup_every": 4, "touch_every": 8}
CLIENT_GOLDEN_PATH = GOLDEN_PATH.with_name("client_golden.json")
# testing/client_runs.Spec fields. The small fleet has one document of
# each late-joiner kind; the card's has two of each, three rounds and 32
# edits a sequence a writer a wave.
CLIENT_CARD = {"docs": 8, "rounds": 3, "ops": 32}
CLIENT_SMALL = {"docs": 4, "rounds": 2, "ops": 24}
APP_GOLDEN_PATH = GOLDEN_PATH.with_name("app_golden.json")
CLUSTER_GOLDEN_PATH = GOLDEN_PATH.with_name("cluster_golden.json")
# testing/cluster_runs.Spec fields. The card's cluster is phase 19 (a)'s
# fleet (8 documents, 3 writers each) on three nodes, with three waves on
# each side of the owner's death; the small one is the JAX test's shape
# widened to two documents.
CLUSTER_CARD = {"docs": 8, "nodes": 3, "before": 3, "after": 3, "ops": 16}
CLUSTER_SMALL = {"docs": 2, "nodes": 2, "before": 2, "after": 2, "ops": 8}
DEPLOY_GOLDEN_PATH = GOLDEN_PATH.with_name("deploy_golden.json")
# testing/deploy_runs.Spec fields. The card's fleet keeps phase 17's
# traffic widths (32 inserts a document a wave in boxcars of 8) at 32 of
# its 512 documents and 1 of its 3 measured waves: the worker persists
# each delta, each scribe checkpoint and each broker commit with a sqlite
# or gRPC round trip of its own, milliseconds a message on the host
# (PERF.md §4). The small fleet is the CPU tests'.
DEPLOY_CARD = {"docs": 32, "ops": 32, "warm": 1, "measured": 1}
DEPLOY_SMALL = {"docs": 8, "ops": 8, "warm": 1, "measured": 1}
CAPACITY_GOLDEN_PATH = GOLDEN_PATH.with_name("capacity_golden.json")
DECAY_GOLDEN_PATH = GOLDEN_PATH.with_name("decay_golden.json")
# (documents, ops a document a wave, waves) of the decay probe's runs: the
# tool's documented default (decay_probe.py main) and the JAX test's.
DECAY_CARD = (256, 16, 40)
DECAY_SMALL = (32, 8, 16)
LANES_GOLDEN_PATH = GOLDEN_PATH.with_name("lane_store_golden.npz")
LANES_JSON_PATH = GOLDEN_PATH.with_name("lane_store_golden.json")
# The fields of a packed extraction (kernel.extract_visible_batched).
PACKED_FIELDS = ("origin_op", "origin_off", "length", "anno", "ins_seq",
                 "ins_client", "rem_seq", "rem_client", "counts")


def load(path: Path = GOLDEN_PATH) -> Dict[str, Dict[str, np.ndarray]]:
    """{section: {field: array}}."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            section, field = key.split(".", 1)
            out.setdefault(section, {})[field] = data[key]
    return out


def save(sections: Dict[str, Dict[str, np.ndarray]],
         path: Path = GOLDEN_PATH) -> None:
    flat = {f"{section}.{field}": np.asarray(arr)
            for section, fields in sections.items()
            for field, arr in fields.items()}
    np.savez_compressed(path, **flat)


def entries_text(entries: List[dict]) -> str:
    """The visible text of snapshot entries at the local view: removed
    rows (acked or pending) are left out, a marker is U+FFFC."""
    from ..mergetree.constants import SEG_MARKER
    return "".join("\ufffc" if e.get("kind") == SEG_MARKER else e["text"]
                   for e in entries if e.get("removedSeq") is None
                   and e.get("removedLocalSeq") is None)


def canonical_entries(entries: List[dict]) -> str:
    """Entries as canonical JSON (payloads wire-encoded, keys sorted, no
    spaces)."""
    from ..mergetree.runs import encode_entry_payloads
    return json.dumps(encode_entry_payloads(entries), sort_keys=True,
                      separators=(",", ":"))


def entries_digest(entries: List[dict]) -> Dict[str, object]:
    """{count, visible_length, entries_sha256, text_sha256} of snapshot
    entries."""
    text = entries_text(entries)
    return {"count": len(entries), "visible_length": len(text),
            "entries_sha256": hashlib.sha256(
                canonical_entries(entries).encode()).hexdigest(),
            "text_sha256": hashlib.sha256(text.encode()).hexdigest()}


def trace_text(trace) -> str:
    """The visible text of a one-client keystroke trace (testing/traces.
    keystroke_trace) replayed on a plain string: each op's positions are
    in the text as it stands, since every op refers to the one before it.
    tests/test_torch_golden.py holds it to the catch-up golden's digest of
    the whole 100,000-op trace; chip_smoke.py phase 21 (a) holds a prefix
    of the trace to it."""
    text = ""
    for op, *_ in trace:
        if op["type"] == 0:
            pos = op["pos1"]
            text = text[:pos] + op["seg"]["text"] + text[pos:]
        elif op["type"] == 1:
            text = text[:op["pos1"]] + text[op["pos2"]:]
    return text


def load_catchup(path: Path = CATCHUP_GOLDEN_PATH) -> dict:
    """{"small": {"trace", "entries"}, "full": {"trace", "digest"}}, the
    small entries decoded back to the port's payload types."""
    from ..mergetree.runs import decode_entry_payloads
    with open(path) as f:
        data = json.load(f)
    data["small"]["entries"] = decode_entry_payloads(
        data["small"]["entries"])
    return data


def save_catchup(data: dict, path: Path = CATCHUP_GOLDEN_PATH) -> None:
    from ..mergetree.runs import encode_entry_payloads
    out = {"small": dict(data["small"]), "full": dict(data["full"])}
    out["small"]["entries"] = encode_entry_payloads(
        out["small"]["entries"])
    with open(path, "w") as f:
        json.dump(out, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


def extract_streams(builder) -> list:
    """The extraction golden's op streams through `builder` (an OpBuilder
    of either package): EXTRACT_SEEDS' rich documents, an empty one, and
    one whose live seqs span more than int16."""
    from .traces import summary_stream
    streams = [summary_stream(builder, seed, EXTRACT_OPS)
               for seed in EXTRACT_SEEDS]
    return streams + [[], summary_stream(builder, EXTRACT_GAP_SEED,
                                         EXTRACT_OPS,
                                         seq_gap=EXTRACT_SEQ_GAP)]


def encode_payloads(table) -> list:
    """A payload table (either package's) as JSON: an insert as {"kind",
    "text", "props"}, an annotate as {"props", "seq", "local_seq"}, a freed
    slot as null. Text payloads only."""
    out = []
    for e in table.entries:
        if e is None:
            out.append(None)
        elif hasattr(e, "kind"):
            out.append({"kind": e.kind, "text": e.text, "props": e.props})
        else:
            out.append({"props": e.props, "seq": e.seq,
                        "local_seq": e.local_seq})
    return out


def decode_payloads(entries: list):
    """encode_payloads' inverse, as the port's PayloadTable."""
    from ..mergetree.host import AnnotatePayload, InsertPayload, PayloadTable
    table = PayloadTable()
    for e in entries:
        if e is None:
            table.entries.append(None)
        elif "kind" in e:
            table.entries.append(InsertPayload(e["kind"], e["text"],
                                               e["props"]))
        else:
            table.entries.append(AnnotatePayload(e["props"], e["seq"],
                                                 e["local_seq"]))
    table.free_ids = [i for i, e in enumerate(table.entries) if e is None]
    return table


def load_extract() -> dict:
    """The extraction golden: the .npz sections, plus "json" holding
    {"payloads" (a PayloadTable), "snapshots" ({doc: snapshot}),
    "catchup_base", "catchup_blob"}."""
    out = load(EXTRACT_GOLDEN_PATH)
    with open(EXTRACT_JSON_PATH) as f:
        data = json.load(f)
    data["payloads"] = decode_payloads(data["payloads"])
    data["snapshots"] = {int(k): v for k, v in data["snapshots"].items()}
    out["json"] = data
    return out


def save_extract(sections: Dict[str, Dict[str, np.ndarray]],
                 doc: dict) -> None:
    """Write both extraction golden files; `doc` holds "payloads" already
    encoded."""
    save(sections, EXTRACT_GOLDEN_PATH)
    with open(EXTRACT_JSON_PATH, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


def load_lanes() -> dict:
    """The lane-store golden: the .npz sections, plus "json"."""
    out = load(LANES_GOLDEN_PATH)
    with open(LANES_JSON_PATH) as f:
        out["json"] = json.load(f)
    return out


def save_lanes(sections: Dict[str, Dict[str, np.ndarray]],
               doc: dict) -> None:
    save(sections, LANES_GOLDEN_PATH)
    with open(LANES_JSON_PATH, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


def load_lambda(path: Path = LAMBDA_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_lambda(doc: dict, path: Path = LAMBDA_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


def load_server(path: Path = SERVER_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_server(doc: dict, path: Path = SERVER_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


def load_client(path: Path = CLIENT_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_client(doc: dict, path: Path = CLIENT_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


def load_app(path: Path = APP_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_app(doc: dict, path: Path = APP_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


def load_cluster(path: Path = CLUSTER_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_cluster(doc: dict, path: Path = CLUSTER_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


def load_deploy(path: Path = DEPLOY_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_deploy(doc: dict, path: Path = DEPLOY_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


def load_decay(path: Path = DECAY_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_decay(doc: dict, path: Path = DECAY_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


def load_capacity(path: Path = CAPACITY_GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def save_capacity(doc: dict, path: Path = CAPACITY_GOLDEN_PATH) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")
