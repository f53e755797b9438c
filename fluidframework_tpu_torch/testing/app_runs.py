"""The application layer's scenario, run the same way on either package.

`run` opens a small document the way an application does and then takes
it through the offline document path:

1. a `BaseHost` over a `CodeLoader` whose one module is a
   `ContainerRuntimeFactoryWithDefaultDataStore` of `Notes`, a
   `DataObject`, on the package's `TpuLocalServer` (the ticket scan and
   the lane stores on the card for the port); the host creates and
   attaches the document, and the default object is resolved with
   `request("/")`;
2. after the attach summary, the first writer's `Notes` creates a
   SharedString live and keeps its handle in its root directory; a second
   container of the host resolves the handle through the framework's
   request handler chain. Since the channel is created after the attach
   summary, its attach op and every op on it stay in the document's tail;
3. the two writers type `OPS` ops of the keystroke trace (seeded), each
   op through the writer the trace names, a pump whenever the writer
   changes, and before op COMMENT_AT the second writer adds a comment
   and deletes it (`comment`: without it a reload would absorb the whole
   tail lazily and launch nothing); then the first writer's edits go
   through an
   `UndoRedoStackManager` with a `SharedSegmentSequenceUndoRedoHandler`:
   a grouped edit, two undos and a redo;
4. a `client_api.Document` on the same server: created with a root
   directory and a string, loaded by a second facade, edited from both;
5. `fetch_document` captures the text document into a temporary directory
   (summary.json, ops.json, stats.json);
6. a second `BaseHost` over `FileDocumentServiceFactory` reopens the
   capture: its loader takes the tail through `Container._process_bulk`,
   so the text's run reaches `MergeTreeClient.apply_bulk`;
7. `ReplayTool.from_capture(...).run(ReplayArgs(snap_freq=SNAP_FREQ))`
   replays the capture with its snapshot points and storage checks.

`run` returns sha256 digests of canonical JSON (testing/lambda_runs.py's
`digest`) of every summary (each container's `_assemble_summary()` in
dict form, the captured summary), every text, and every snapshot point
of the replay (its sequence number and canonical summary), with the
fetch tool's statistics, the replay's final sequence number and its
mismatches, and the apply_bulk calls made while the file driver and the
replay tool loaded. Two runs compare by equality.

What a run takes from outside is pinned in the package's own modules and
restored afterwards by testing/client_runs.pinned: the client ids
(`uuid` in local_server), the git store's commit clock, the delta
manager's idle clock, the interval ids, the `random` module's state, and
FLUID_TPU_FORCE_BULK=1 (a bulk and a scalar replay give the same text but
may segment it differently, and a summary records the segments).

The JAX package cannot run the scenario as it stands, for three faults
the port repairs (ROADMAP Queue 3): its replay tool loads its containers
without client details, so the tool's first forward of 25 ops or more
raises PermissionError (a NO_OP on the read-only replay connection); its
SharedDirectory cannot summarize a handle value (json.dumps raises
TypeError on the FluidHandle); and its replay tool compares summaries
byte for byte, segment boundaries included, so a straight load through
the bulk catch-up and a snapshot-plus-tail replay differ where their
texts agree. For the reference package (`reference` True)
`reference_pins` therefore loads the tool's containers read-only (the
port's tools/replay_tool.CLIENT_DETAILS), has SubDirectory.to_dict give
handles in their wire form, as the port's SharedDirectory.summarize_core
serializes them, and gives the tool the port's canonical form
(tools/replay_tool.canonical_summary); all are restored afterwards.

The scenario takes an `AppPackage` of one package's modules and the
keyword arguments its TpuLocalServer and its Loader-building entry points
take (device="cuda" or "cpu" for the port). tests/test_torch_offline_tools.py runs it through
the JAX package to build testing/golden/app_golden.json (its `--write`
entry point) and holds both packages to it; chip_smoke.py phase 20 (b)
runs it on the card and, in a child process, on the CPU. `run_counted`
also returns the scan-apply launches made under apply_bulk by part, read
from the package's `scan_launches`. Apart from `port_package`, which
loads the port's modules, this module needs neither torch nor JAX.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
from typing import Any, Callable, NamedTuple, Optional, Tuple

from .client_runs import config, pinned
from .lambda_runs import digest
from .server_runs import _Cfg

OPS = 1_500            # keystroke-trace ops typed by the two writers
COMMENT_AT = 300       # the trace op before which a comment comes and goes
TRACE_SEED = 41
SNAP_FREQ = 500        # the replay tool's snapshot frequency
SEED = 29              # the pins' seed
DOC = "notes"
PACKAGE = {"package": "notes-app", "version": "^1.0.0"}
PARTS = ("file_load", "replay")


class AppPackage(NamedTuple):
    local_server: Any      # server/local_server module
    storage: Any           # server/storage module
    delta_manager: Any     # loader/delta_manager module
    sequence: Any          # dds/sequence module
    summary: Any           # protocol/summary module
    client: Any            # mergetree/client module
    framework: Any         # framework package
    code_loader: Any       # loader/code_loader module
    hosts: Any             # hosts package
    client_api: Any        # client_api module
    local_driver: Any      # loader/drivers/local module
    file_driver: Any       # loader/drivers/file module
    tools: Any             # tools package (fetch, replay)
    traces: Any            # testing/traces module
    kwargs: dict           # extra arguments of TpuLocalServer, BaseHost,
    #                        Document and ReplayTool (device=...)
    directory: Any         # dds/directory module
    shared_object: Any     # dds/shared_object module
    # The scan-apply kernel's launch count, where the package has one.
    scan_launches: Optional[Callable[[], int]] = None
    # The JAX package: the run applies reference_pins.
    reference: bool = False


def port_package(device) -> AppPackage:
    """The port's AppPackage on `device` (its modules import torch, so
    they load here, on the first call)."""
    from .. import client_api, framework, hosts, tools
    from ..dds import directory, sequence, shared_object
    from ..loader import code_loader, delta_manager
    from ..loader.drivers import file, local
    from ..mergetree import client, kernel
    from ..protocol import summary
    from ..server import local_server, storage
    from . import traces
    return AppPackage(local_server, storage, delta_manager, sequence, summary,
                      client, framework, code_loader, hosts, client_api,
                      local, file, tools, traces, {"device": device},
                      directory, shared_object,
                      lambda: kernel.scan_apply.launches)


def run(pkg: AppPackage) -> dict:
    """The scenario on one package: its digests and counts."""
    return run_counted(pkg)[0]


def run_counted(pkg: AppPackage) -> Tuple[dict, dict]:
    """`run`'s result, and the scan-apply launches made under apply_bulk
    while the file driver reloaded the capture ("file_load") and while the
    replay tool ran ("replay"); all 0 where the package has no launch
    count. The launches stay out of the result, which the CPU and the card
    must agree on."""
    bulk = {"part": None, "calls": {p: 0 for p in PARTS},
            "launches": {p: 0 for p in PARTS}}
    apply_bulk = pkg.client.MergeTreeClient.apply_bulk
    launches = pkg.scan_launches or (lambda: 0)

    def counted(self, tail, *args):
        part, n0 = bulk["part"], launches()
        try:
            return apply_bulk(self, tail, *args)
        finally:
            if part is not None:
                bulk["calls"][part] += 1
                bulk["launches"][part] += launches() - n0

    pkg.client.MergeTreeClient.apply_bulk = counted
    try:
        with pinned(pkg, SEED), reference_pins(pkg), \
                tempfile.TemporaryDirectory() as tmp:
            return _run(pkg, bulk, tmp), bulk["launches"]
    finally:
        pkg.client.MergeTreeClient.apply_bulk = apply_bulk


@contextlib.contextmanager
def reference_pins(pkg: AppPackage):
    """For the reference package, the two repairs the port makes (see the
    module's docstring); restored on exit. Nothing for the port."""
    if not pkg.reference:
        yield
        return
    from ..tools.replay_tool import coalesce_sequences
    tool = pkg.tools.replay_tool
    container, to_dict = tool.Container, pkg.directory.SubDirectory.to_dict
    canonical = tool.canonical_summary
    encode = pkg.shared_object.encode_handles

    class ReadOnly(container):
        @staticmethod
        def load(document_id, service, *args, **kwargs):
            kwargs.setdefault("client_details", {"mode": "read"})
            return container.load(document_id, service, *args, **kwargs)

    tool.Container = ReadOnly
    pkg.directory.SubDirectory.to_dict = lambda self: encode(to_dict(self))
    tool.canonical_summary = lambda summary: json.dumps(coalesce_sequences(
        pkg.summary.summary_tree_to_dict(summary)), sort_keys=True)
    try:
        yield
    finally:
        tool.Container = container
        pkg.directory.SubDirectory.to_dict = to_dict
        tool.canonical_summary = canonical


def notes_class(framework):
    """The scenario's data object, a DataObject of `framework`."""

    class Notes(framework.DataObject):
        def initializing_first_time(self):
            self.root.set("title", "untitled")

        def text(self):
            """The string the root's handle names, resolved through the
            container runtime's request handler chain."""
            chain = framework.RequestHandlerChain(
                framework.datastore_route_handler(self.store.container))
            return chain.request(self.root.get("text").absolute_path)

    return Notes


def comment(text, server) -> None:
    """A comment on `text` (an interval of its "comments" collection),
    added and then deleted, each sequenced. A reload absorbs a string's
    tail lazily as deferrals when it can (dds/sequence.py), with no
    launch; the interval op ends that, the body materializes, and the
    tail splits there: the merge runs before the add and after the delete
    reach MergeTreeClient.apply_bulk, the run between them, while the
    comment's anchors live, replays per op."""
    comments = text.get_interval_collection("comments")
    interval = comments.add(0, min(4, text.get_length()), {"by": "review"})
    server.pump()
    comments.remove_interval_by_id(interval.interval_id)
    server.pump()


def apply_trace_op(text, op: dict) -> None:
    if op["type"] == 0:
        text.insert_text(op["pos1"], op["seg"]["text"],
                         op["seg"].get("props"))
    elif op["type"] == 1:
        text.remove_text(op["pos1"], op["pos2"])
    else:
        text.annotate_range(op["pos1"], op["pos2"], op["props"])


def tree(pkg: AppPackage, container) -> dict:
    return pkg.summary.summary_tree_to_dict(container._assemble_summary())


def _run(pkg: AppPackage, bulk: dict, tmp: str) -> dict:
    F = pkg.framework
    server = pkg.local_server.TpuLocalServer(
        auto_pump=False, config=_Cfg(config()), **pkg.kwargs)
    factory = pkg.local_driver.LocalDocumentServiceFactory(server)
    code = pkg.code_loader.CodeLoader()
    runtime_factory = F.ContainerRuntimeFactoryWithDefaultDataStore(
        F.DataObjectFactory("notes", notes_class(F)))
    code.register("notes-app", "1.0.0", runtime_factory)
    host = pkg.hosts.BaseHost(factory, code, PACKAGE, **pkg.kwargs)

    c1 = host.initialize_container(DOC)
    server.pump()
    obj1 = c1.request("/")
    string = obj1.store.create_channel("text",
                                       pkg.sequence.SharedString.TYPE)
    obj1.root.set("text", string.handle)
    server.pump()
    c2 = host.initialize_container(DOC)
    server.pump()
    obj2 = c2.request("/")
    writers = [obj1.text(), obj2.text()]

    last = None
    for i, (op, _seq, _ref, client, _msn) in enumerate(
            pkg.traces.keystroke_trace(OPS, seed=TRACE_SEED, n_clients=2)):
        if client != last:
            server.pump()
            last = client
        if i == COMMENT_AT:
            server.pump()
            comment(writers[1], server)
        apply_trace_op(writers[client - 1], op)
    server.pump()

    undo = F.UndoRedoStackManager()
    F.SharedSegmentSequenceUndoRedoHandler(undo).attach(writers[0])
    steps = []
    undo.open_current_operation()
    writers[0].insert_text(0, "Title: ")
    writers[0].annotate_range(0, 5, {"bold": True})
    undo.close_current_operation()
    writers[0].remove_text(7, 12)
    server.pump()
    for action in (undo.undo_operation, undo.undo_operation,
                   undo.redo_operation):
        steps.append(action())
        server.pump()
        steps.append(writers[1].get_text())
    obj2.root.set("title", "shared notes")
    server.pump()

    legacy = pkg.client_api.Document.create("legacy", factory, **pkg.kwargs)
    server.pump()
    legacy.get_root().set("greeting", "hello")
    story = legacy.create_string("story")
    story.insert_text(0, "once upon a time")
    server.pump()
    legacy2 = pkg.client_api.Document.load("legacy", factory, **pkg.kwargs)
    server.pump()
    legacy2.get("story").insert_text(0, "and ")
    server.pump()

    summary, ops, stats = pkg.tools.fetch_document(
        factory, DOC, out_dir=f"{tmp}/{DOC}")
    reader = pkg.hosts.BaseHost(pkg.file_driver.FileDocumentServiceFactory(
        tmp), code, PACKAGE, **pkg.kwargs)
    bulk["part"] = "file_load"
    try:
        c3 = reader.initialize_container(DOC)
        obj3 = c3.request("/")
        loaded = obj3.text()
    finally:
        bulk["part"] = None
    tool = pkg.tools.ReplayTool.from_capture(f"{tmp}/{DOC}", **pkg.kwargs)
    bulk["part"] = "replay"
    try:
        result = tool.run(pkg.tools.ReplayArgs(snap_freq=SNAP_FREQ))
    finally:
        bulk["part"] = None

    texts = {"writers": [w.get_text() for w in writers],
             "loaded": loaded.get_text(),
             "titles": [o.root.get("title") for o in (obj1, obj2, obj3)],
             "legacy": [d.get("story").get_text() for d in (legacy, legacy2)],
             "greeting": legacy2.get_root().get("greeting"),
             "undo": steps}
    trees = {"writers": [tree(pkg, c) for c in (c1, c2)],
             "loaded": tree(pkg, c3),
             "legacy": [tree(pkg, d.container) for d in (legacy, legacy2)],
             "captured": pkg.summary.summary_tree_to_dict(summary)}
    with open(f"{tmp}/{DOC}/stats.json") as f:
        stats_file = json.load(f)
    return {
        "ops": len(ops),
        "chars": len(texts["loaded"]),
        "texts": digest(texts),
        "summaries": digest(trees),
        "snapshots": [[s.sequence_number, digest(s.canonical)]
                      for s in result.snapshots],
        "final_seq": result.final_seq,
        "mismatches": result.mismatches,
        "fetch": {"op_count": stats.op_count, "first_seq": stats.first_seq,
                  "last_seq": stats.last_seq,
                  "ops_by_type": stats.ops_by_type,
                  "clients": len(stats.ops_by_client),
                  "summary_blobs": stats.summary_blob_count,
                  "summary_bytes": stats.summary_bytes,
                  "stats_file": digest(stats_file)},
        "bulk_applies": dict(bulk["calls"]),
        "loaded_equal": texts["loaded"] == texts["writers"][0]
        == texts["writers"][1],
    }
