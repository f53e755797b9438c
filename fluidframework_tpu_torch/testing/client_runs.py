"""The client stack's scenario, run the same way on either package.

`run` drives a seeded fleet of documents through a package's Loader, its
local driver and its DDSes against that package's TpuLocalServer, the way
an application does: create-detached, attach, resolve, edit, `pump`,
`Container.summarize`, disconnect and reconnect. Every document holds one
data store with two SharedStrings ("text" without intervals, "marks" with
an interval collection), a SharedNumberSequence ("nums"), a SharedMatrix
("grid"), a SharedMap ("kv"), a SharedDirectory ("tree") and a
SharedCounter ("count"), except where a kind below says otherwise. Three
writers edit each document concurrently in
waves (the sequences in one wave, the other channels in the next, so a
catch-up tail holds runs of sequence ops long enough for the bulk path),
writer 0 summarizes, and then one late joiner of a kind comes to each
document, the kind cycling with the document's index:

1. a document whose sequence channels were created live after its attach
   summary, so their attach ops and every op on them are in the tail; the
   tail's runs on channels without local references reach
   MergeTreeClient.apply_bulk;
2. a resolve from the summary in the ordinary way: the sequences load
   lazily, absorb the tail as deferrals and replay them per-op at first
   touch;
3. a read-only resolve after `refresh_catchup`, which adopts the server's
   catch-up artifact. The server publishes an artifact only for a document
   whose every channel is a plain sequence lane (no LWW, matrix or
   directory lane, no interval op), and a client adopts one only when no
   channel holds intervals, so these documents hold "text" and "nums"
   alone;
4. a resolve that reads every sequence (materializing them), disconnects,
   misses a wave of more than 64 ops a sequence, and reconnects: the gap
   goes through DeltaManager's catch-up into Container._process_bulk, and
   its runs on channels without local references reach apply_bulk.

TpuLocalServer.get_catchup builds an artifact on demand, so kinds 1, 2
and 4 set the read tier aside for their resolve or reconnect
(`server.catchup = None`, then restored); kind 3 keeps it. A last wave
comes from the writers and the late joiners that may write, then every
document is summarized again.

`run` returns sha256 digests of canonical JSON (testing/lambda_runs.py's
`digest`) of each client's channel contents, each client's summary tree
(dict form), each committed summary tree, and each document's delta
stream, with counts: the apply_bulk calls made while each kind caught up,
the artifacts adopted, and the read-tier failures swallowed (which must be
none). Two runs compare by equality. `diverged` lists the channel contents
on which a document's clients disagree: the JAX package leaves an
interval's end on its creator where the other replicas slide it, and the
port keeps that.

What a run takes from outside is pinned in the package's own modules and
restored afterwards, as testing/server_runs.py pins it: the client ids
(`uuid` in local_server), the git store's commit clock (`time` in
storage), the delta manager's idle clock (`time` in delta_manager, so no
heartbeat is sent by wall time), the interval ids (`_interval_uid` in
dds/sequence), the matrix's run-id nonces (the `random` module's state),
and the bulk route: FLUID_TPU_FORCE_BULK=1, as the tests run it, since a
bulk and a scalar replay give the same text but may segment it
differently, and a summary records the segments.

The scenario takes a `ClientPackage` of one package's modules plus the
keyword arguments of its TpuLocalServer and Loader (device="cuda" or
"cpu" for the port). chip_smoke.py phase 19 runs it on the card and, in a
child process, on the CPU; tests/test_torch_client_golden.py runs it
through the JAX package to build testing/golden/client_golden.json.
`run_counted` also returns the scan-apply launches made under apply_bulk
by late-joiner kind, read from the package's `scan_launches`. Apart
from `port_package`, which loads the port's modules, this module needs
neither torch nor JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

from .lambda_runs import digest
from .server_runs import _CommitClock, _Cfg, _SeededUuid

STORE = "default"
SEQUENCES = ("text", "marks", "nums")
KINDS = (1, 2, 3, 4)
WRITERS = 3
SWALLOWS = ("swallowed.container.get_catchup", "catchup.client.fetch_failed")


class ClientPackage(NamedTuple):
    local_server: Any      # server/local_server module
    storage: Any           # server/storage module
    summary: Any           # protocol/summary module
    counters: Any          # telemetry/counters module
    container: Any         # loader/container module
    delta_manager: Any     # loader/delta_manager module
    local_driver: Any      # loader/drivers/local module
    client: Any            # mergetree/client module
    sequence: Any          # dds/sequence module
    matrix: Any            # dds/matrix module
    map: Any               # dds/map module
    directory: Any         # dds/directory module
    counter: Any           # dds/counter module
    server_kwargs: dict    # extra TpuLocalServer arguments (device=...)
    loader_kwargs: dict    # extra Loader arguments (device=...)
    # The scan-apply kernel's launch count, where the package has one.
    scan_launches: Optional[Callable[[], int]] = None


def port_package(device) -> ClientPackage:
    """The port's ClientPackage on `device` (its modules import torch, so
    they load here, on the first call)."""
    from ..dds import counter, directory, map, matrix, sequence
    from ..loader import container, delta_manager
    from ..loader.drivers import local
    from ..mergetree import client, kernel
    from ..protocol import summary
    from ..server import local_server, storage
    from ..telemetry import counters
    return ClientPackage(local_server, storage, summary, counters,
                         container, delta_manager, local, client, sequence,
                         matrix, map, directory, counter,
                         {"device": device}, {"device": device},
                         lambda: kernel.scan_apply.launches)


class Spec(NamedTuple):
    """One fleet: `docs` documents, `rounds` rounds of a sequence wave and
    an LWW wave before the summary and one after it; a writer makes `ops`
    edits a sequence a sequence wave and `lww` edits a channel an LWW
    wave."""
    docs: int = 4
    rounds: int = 2
    ops: int = 24
    lww: int = 3
    seed: int = 23


def config() -> dict:
    """The server's configuration: the read tier on, admission's queue
    above any wave, and the two wall-clock controls off (ghost-client
    eviction and admission's latency term, whose SLO stage names a
    histogram nothing records)."""
    return {"catchup.enabled": True,
            "admission.queueLimit": 65536,
            "admission.sloStage": "client_runs.unrecorded",
            "deli.clientTimeoutMsec": 0}


class _FrozenClock:
    """Stands in for the time module in delta_manager: the idle heartbeat
    never comes due, so NO_OPs follow the op count alone."""

    @staticmethod
    def monotonic() -> float:
        return 0.0


def run(pkg: ClientPackage, spec: Spec) -> dict:
    """The scenario on one package: its digests and counts."""
    return run_counted(pkg, spec)[0]


@contextlib.contextmanager
def pinned(pkg, seed: int) -> Iterator[None]:
    """Pins what a run takes from outside, in `pkg`'s modules (any object
    with ClientPackage's local_server, storage, delta_manager and
    sequence), and restores it on exit: the client ids, the commit clock,
    the delta manager's idle clock, the interval ids, the `random`
    module's state, and FLUID_TPU_FORCE_BULK=1."""
    saved = (pkg.local_server.uuid, pkg.storage.time,
             pkg.delta_manager.time, pkg.sequence._interval_uid,
             random.getstate(), os.environ.get("FLUID_TPU_FORCE_BULK"))
    pkg.local_server.uuid = _SeededUuid(seed)
    pkg.storage.time = _CommitClock()
    pkg.delta_manager.time = _FrozenClock()
    pkg.sequence._interval_uid = itertools.count(1)
    random.seed(seed)
    os.environ["FLUID_TPU_FORCE_BULK"] = "1"
    try:
        yield
    finally:
        (pkg.local_server.uuid, pkg.storage.time, pkg.delta_manager.time,
         pkg.sequence._interval_uid, state, force) = saved
        random.setstate(state)
        if force is None:
            os.environ.pop("FLUID_TPU_FORCE_BULK", None)
        else:
            os.environ["FLUID_TPU_FORCE_BULK"] = force


def run_counted(pkg: ClientPackage, spec: Spec) -> Tuple[dict, dict]:
    """The scenario on one package: `run`'s result, and the scan-apply
    launches made under apply_bulk while each kind of late joiner caught
    up (all 0 where the package has no launch count). The launches stay
    out of the result, which the CPU and the card must agree on."""
    bulk = {"kind": None, "calls": {k: 0 for k in KINDS},
            "launches": {k: 0 for k in KINDS}}
    apply_bulk = pkg.client.MergeTreeClient.apply_bulk
    launches = pkg.scan_launches or (lambda: 0)

    def counted(self, tail, *args):
        kind, n0 = bulk["kind"], launches()
        try:
            return apply_bulk(self, tail, *args)
        finally:
            if kind is not None:
                bulk["calls"][kind] += 1
                bulk["launches"][kind] += launches() - n0

    pkg.client.MergeTreeClient.apply_bulk = counted
    try:
        with pinned(pkg, spec.seed):
            return _Run(pkg, spec, bulk).run(), bulk["launches"]
    finally:
        pkg.client.MergeTreeClient.apply_bulk = apply_bulk

def kind_of(d: int) -> int:
    return KINDS[d % len(KINDS)]


class _Run:
    def __init__(self, pkg: ClientPackage, spec: Spec, bulk):
        self.pkg, self.spec, self.bulk = pkg, spec, bulk
        self.server = pkg.local_server.TpuLocalServer(
            auto_pump=False, config=_Cfg(config()), **pkg.server_kwargs)
        self.loader = pkg.container.Loader(
            pkg.local_driver.LocalDocumentServiceFactory(self.server),
            **pkg.loader_kwargs)
        self.docs = [f"doc{d}" for d in range(spec.docs)]
        self.writers: Dict[str, list] = {}
        self.late: Dict[str, Any] = {}
        self.wave_no = 0

    # -- helpers -----------------------------------------------------------
    def pump(self) -> None:
        self.server.pump()

    @staticmethod
    def channels(container) -> dict:
        store = container.runtime.get_datastore(STORE)
        return store.channels

    def create_sequences(self, ds, plain: bool = False) -> None:
        P = self.pkg
        ds.create_channel("text", P.sequence.SharedString.TYPE)
        if not plain:
            ds.create_channel("marks", P.sequence.SharedString.TYPE)
        ds.create_channel("nums", P.sequence.SharedNumberSequence.TYPE)

    def create_lww(self, ds) -> None:
        P = self.pkg
        grid = ds.create_channel("grid", P.matrix.SharedMatrix.TYPE)
        grid.insert_rows(0, 4)
        grid.insert_cols(0, 4)
        ds.create_channel("kv", P.map.SharedMap.TYPE).set("title", "t")
        ds.create_channel("tree", P.directory.SharedDirectory.TYPE)
        ds.create_channel("count", P.counter.SharedCounter.TYPE)

    def setup(self) -> None:
        for d, doc in enumerate(self.docs):
            c0 = self.loader.create_detached(doc)
            ds = c0.runtime.create_datastore(STORE)
            kind = kind_of(d)
            if kind != 1:
                self.create_sequences(ds, plain=kind == 3)
                ch = ds.channels
                ch["text"].insert_text(0, f"{doc} text")
                ch["nums"].insert_range(0, [d, d + 1, d + 2])
                if "marks" in ch:
                    ch["marks"].insert_text(0, f"{doc} marks")
            if kind != 3:
                self.create_lww(ds)
            c0.attach()
            self.pump()
            writers = [c0]
            for _ in range(WRITERS - 1):
                writers.append(self.loader.resolve(doc))
                self.pump()
            if kind == 1:
                self.create_sequences(c0.runtime.get_datastore(STORE))
                self.pump()
            marks = self.channels(c0).get("marks")
            if marks is not None:
                marks.get_interval_collection("bookmarks").add(
                    1, 4, {"doc": doc})
                self.pump()
            self.writers[doc] = writers

    def rng(self, *key) -> random.Random:
        return random.Random(repr((self.spec.seed,) + key))

    def edit_string(self, s, rng, tag: str) -> None:
        for i in range(self.spec.ops):
            n = s.get_length()
            r = rng.random()
            if n > 6 and r < 0.25:
                a = rng.randrange(n - 1)
                s.remove_text(a, min(n, a + rng.randrange(1, 5)))
            elif n > 3 and r < 0.35:
                a = rng.randrange(n - 1)
                s.annotate_range(a, a + 1, {"w": tag})
            else:
                s.insert_text(rng.randrange(n + 1), f"{tag}{i % 10}")

    def edit_nums(self, s, rng) -> None:
        for i in range(self.spec.ops):
            n = s.get_length()
            if n > 4 and rng.random() < 0.3:
                a = rng.randrange(n - 1)
                s.remove_range(a, a + 1)
            else:
                s.insert_range(rng.randrange(n + 1),
                               [rng.randrange(100), i])

    def edit_lww(self, ch, rng, tag: str) -> None:
        grid, kv = ch["grid"], ch["kv"]
        tree, count = ch["tree"], ch["count"]
        for i in range(self.spec.lww):
            grid.set_cell(rng.randrange(grid.row_count),
                          rng.randrange(grid.col_count), f"{tag}.{i}")
            kv.set(f"k{rng.randrange(6)}", [tag, i])
            sub = tree.get_sub_directory(f"s{rng.randrange(3)}") or \
                tree.create_sub_directory(f"s{rng.randrange(3)}")
            sub.set(f"k{rng.randrange(4)}", i)
            count.increment(1 + i % 3)

    def sequence_wave(self, docs=None, extra=None) -> None:
        wave = self.wave_no
        self.wave_no += 1
        for doc in (self.docs if docs is None else docs):
            for w, c in enumerate(self.editors(doc, extra)):
                rng = self.rng("seq", doc, wave, w)
                ch = self.channels(c)
                tag = f"{chr(97 + w)}{wave}"
                self.edit_string(ch["text"], rng, tag)
                if "marks" in ch:
                    self.edit_string(ch["marks"], rng, tag)
                self.edit_nums(ch["nums"], rng)
        self.pump()

    def lww_wave(self, docs=None, extra=None) -> None:
        wave = self.wave_no
        self.wave_no += 1
        for doc in (self.docs if docs is None else docs):
            for w, c in enumerate(self.editors(doc, extra)):
                ch = self.channels(c)
                if "kv" in ch:
                    self.edit_lww(ch, self.rng("lww", doc, wave, w),
                                  f"{chr(97 + w)}{wave}")
        self.pump()

    def editors(self, doc: str, extra) -> list:
        out = list(self.writers[doc])
        if extra and doc in self.late and not self.late[doc].read_only:
            out.append(self.late[doc])
        return out

    def summarize(self) -> Dict[str, str]:
        handles = {}
        for d, doc in enumerate(self.docs):
            if kind_of(d) == 1 and doc not in self.late:
                continue  # its sequences stay in the tail
            handles[doc] = self.writers[doc][0].summarize()
        self.pump()
        return handles

    # -- late joiners --------------------------------------------------------
    def catch_up(self, kind: int, fn, read_tier: bool):
        catchup = self.server.catchup
        if not read_tier:
            self.server.catchup = None
        self.bulk["kind"] = kind
        try:
            return fn()
        finally:
            self.bulk["kind"] = None
            self.server.catchup = catchup

    @staticmethod
    def touch(container) -> None:
        ch = _Run.channels(container)
        for name in SEQUENCES:
            if name in ch:
                ch[name].client  # materializes a lazy body

    def late_joiners(self) -> None:
        self.server.refresh_catchup()
        for d, doc in enumerate(self.docs):
            kind = kind_of(d)
            if kind == 3:
                self.late[doc] = self.catch_up(
                    kind, lambda doc=doc: self.loader.resolve(
                        doc, {"mode": "read"}), read_tier=True)
            elif kind != 4:
                self.late[doc] = self.catch_up(
                    kind, lambda doc=doc: self.loader.resolve(doc),
                    read_tier=False)
            else:
                c = self.catch_up(kind, lambda doc=doc:
                                  self.loader.resolve(doc), read_tier=False)
                self.pump()
                self.touch(c)
                c.delta_manager.disconnect()
                self.late[doc] = c
            self.pump()
        gap = [doc for d, doc in enumerate(self.docs) if kind_of(d) == 4]
        self.sequence_wave(docs=gap)
        for doc in gap:
            c = self.late[doc]
            self.catch_up(4, lambda c=c: c.reconnect() or c,
                          read_tier=False)
        self.pump()
        for c in self.late.values():
            self.touch(c)

    # -- the run -------------------------------------------------------------
    def run(self) -> dict:
        C = self.pkg.counters
        before = {k: C.get(k) for k in ("catchup.client.adopted",) + SWALLOWS}
        self.setup()
        for _ in range(self.spec.rounds):
            self.sequence_wave()
            self.lww_wave()
        first = self.summarize()
        self.sequence_wave()
        self.lww_wave()
        self.late_joiners()
        self.sequence_wave(extra=True)
        self.lww_wave(extra=True)
        last = self.summarize()
        return self.digests(first, last, {
            k: C.get(k) - v for k, v in before.items()})

    def contents(self, container) -> dict:
        ch = self.channels(container)
        out = {"text": ch["text"].get_text(), "nums": ch["nums"].get_items()}
        if "marks" in ch:
            marks = ch["marks"].get_interval_collection("bookmarks")
            out.update(marks=ch["marks"].get_text(), intervals=sorted(
                [iv.interval_id, *marks.endpoints(iv), iv.properties]
                for iv in marks))
        if "kv" in ch:
            out.update(grid=ch["grid"].extract(),
                       kv=sorted(ch["kv"].items()),
                       tree=ch["tree"].root.to_dict(),
                       count=ch["count"].value)
        return out

    def clients(self, doc: str) -> list:
        out = list(self.writers[doc])
        if doc in self.late:
            out.append(self.late[doc])
        return out

    def digests(self, first, last, counts) -> dict:
        S = self.pkg.summary
        contents = {doc: [self.contents(c) for c in self.clients(doc)]
                    for doc in self.docs}
        trees = {doc: [S.summary_tree_to_dict(c._assemble_summary())
                       for c in self.clients(doc)] for doc in self.docs}
        committed = {doc: self.server.storage(doc).get(sha).tree_sha
                     for doc, sha in sorted({**first, **last}.items())}
        deltas = {doc: [{k: v for k, v in r.items()
                         if k not in ("timestamp", "traces")}
                        for r in self.server.get_deltas(doc)]
                  for doc in self.docs}
        return {
            "docs": self.spec.docs,
            "waves": self.wave_no,
            "ops": sum(len(v) for v in deltas.values()),
            "diverged": sorted({k for v in contents.values()
                                for c in v[1:] for k in c if c[k] != v[0][k]}),
            "contents": digest(contents),
            "client_summaries": digest(trees),
            "summaries": digest(committed),
            "deltas": digest(deltas),
            "bulk_applies": {str(k): v
                             for k, v in self.bulk["calls"].items()},
            "adopted": counts["catchup.client.adopted"],
            "swallowed": sum(counts[k] for k in SWALLOWS),
            "chars": sum(len(c["text"]) + len(c.get("marks", ""))
                         for v in contents.values() for c in v),
        }
