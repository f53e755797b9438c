"""Record real multi-client sessions into pinned replay corpora.

Drives seeded workloads (testing/traces.py) from multiple clients over
the REAL alfred websocket + REST stack (server/tinylicious.py — the
LocalServer lambda pipeline behind actual sockets), then fetches the
sequenced op log back through alfred's own /deltas catch-up route and
writes it under tests/corpus/ with a pinned end-state digest
(testing/corpus.py). The replay digest is cross-checked against the
LIVE clients' end state at record time, so the checked-in pin holds the
replay harness and the recording session to the same truth.

Reference analog: the captured-log snapshot regression corpus,
packages/test/snapshots/src/replayMultipleFiles.ts:1.

Usage: python -m fluidframework_tpu_torch.testing.record_corpus OUTDIR
    [--only=NAME ...] [--device=DEVICE]

A port of fluidframework_tpu's testing/record_corpus.py. It records only
into the directory it is given and refuses tests/corpus/, whose pins the
port replays and never writes. The sessions' loaders run their containers
on `device` (None means "cuda", which raises without CUDA).
"""

from __future__ import annotations

import json
import os
import random
import sys
import time


def _wait_until(predicate, timeout=30.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _session(server, doc_id: str, channel: str, channel_type: str,
             n_clients: int, device=None):
    from ..loader.container import Loader
    from ..loader.drivers.routerlicious import NetworkDocumentServiceFactory
    from ..server.tinylicious import DEFAULT_TENANT

    factory = NetworkDocumentServiceFactory(server.url, DEFAULT_TENANT)
    loader = Loader(factory, device=device)
    c1 = loader.create_detached(doc_id)
    ds = c1.runtime.create_datastore("default")
    types = {
        "sequence": "https://graph.microsoft.com/types/mergeTree/string",
        "items": "https://graph.microsoft.com/types/mergeTree"
                 "/numberSequence",
        "matrix": "https://graph.microsoft.com/types/sharedmatrix",
        "directory": "https://graph.microsoft.com/types/directory",
    }
    ch1 = ds.create_channel(channel, types[channel_type])
    c1.attach()
    containers = [c1]
    channels = [ch1]
    for _ in range(n_clients - 1):
        c = loader.resolve(doc_id)
        containers.append(c)
        channels.append(
            c.runtime.get_datastore("default").get_channel(channel))
    return containers, channels


def _settle(containers, check, timeout=30.0):
    assert _wait_until(check, timeout), "session did not converge"
    for c in containers:
        c.close()


def record_text(server, outdir: str, n_ops: int = 1500,
                seed: int = 2026, device=None) -> dict:
    """Two-editor keystroke-style text session with annotate sweeps."""
    containers, (t1, t2) = _session(server, "corpus-text", "text",
                                    "sequence", 2, device)
    rng = random.Random(seed)
    editors = [(containers[0], t1), (containers[1], t2)]
    for i in range(n_ops):
        c, t = editors[i % 2 if rng.random() < 0.7 else rng.randrange(2)]
        with c.op_lock:
            n = t.get_length()
            r = rng.random()
            if r < 0.7 or n < 10:
                pos = min(n, max(0, int(rng.gauss(n * 0.7, 4))))
                t.insert_text(pos, rng.choice("abcdefgh ,.!\n"))
            elif r < 0.85:
                a = rng.randrange(n - 2)
                t.remove_text(a, min(n, a + rng.randrange(1, 6)))
            else:
                a = rng.randrange(n - 2)
                t.annotate_range(a, min(n, a + rng.randrange(1, 9)),
                                 {"style": i % 5})
    _settle(containers, lambda: t1.get_text() == t2.get_text())
    return {"doc": "corpus-text", "channel": "text",
            "channel_type": "sequence", "workload": "keystroke",
            "seed": seed, "clients": 2,
            "live_state": {"text": t1.get_text()}}


def record_matrix(server, outdir: str, n_ops: int = 1200,
                  seed: int = 7, device=None) -> dict:
    from .traces import matrix_storm

    containers, (m1, m2) = _session(server, "corpus-matrix", "grid",
                                    "matrix", 2, device)
    with containers[0].op_lock:
        m1.insert_rows(0, 24)
        m1.insert_cols(0, 12)
    _wait_until(lambda: (m2.row_count, m2.col_count) == (24, 12))
    script = matrix_storm(24, 12, n_ops, seed=seed)
    rng = random.Random(seed + 1)
    mats = [(containers[0], m1), (containers[1], m2)]
    for cmd in script:
        c, m = mats[rng.randrange(2)]
        with c.op_lock:
            # The script tracks dimensions for a SERIAL session; across
            # two async clients a view can lag, so commands clamp to the
            # acting client's live dimensions (the log stays realistic —
            # that is what concurrent editors actually submit).
            r, co = m.row_count, m.col_count
            if cmd[0] == "set":
                if r and co:
                    m.set_cell(min(cmd[1], r - 1), min(cmd[2], co - 1),
                               cmd[3])
            elif cmd[0] == "insert_rows":
                m.insert_rows(min(cmd[1], r), cmd[2])
            elif cmd[0] == "insert_cols":
                m.insert_cols(min(cmd[1], co), cmd[2])
            elif cmd[0] == "remove_rows" and r > 2:
                m.remove_rows(min(cmd[1], r - 1), 1)
            elif cmd[0] == "remove_cols" and co > 2:
                m.remove_cols(min(cmd[1], co - 1), 1)
    _settle(containers,
            lambda: m1.extract() == m2.extract())
    return {"doc": "corpus-matrix", "channel": "grid",
            "channel_type": "matrix", "workload": "matrix_storm",
            "seed": seed, "clients": 2,
            "live_state": m1.extract()}


def record_directory(server, outdir: str, n_ops: int = 1200,
                     seed: int = 9, device=None) -> dict:
    from .traces import directory_merge_script

    containers, channels = _session(server, "corpus-dir", "dir",
                                    "directory", 4, device)
    script = directory_merge_script(n_ops, n_clients=4, seed=seed)

    def workdir(d, path):
        node = d.root
        for part in path:
            sub = node.get_sub_directory(part)
            if sub is None:
                sub = node.create_sub_directory(part)
            node = sub
        return node

    for cmd in script:
        cidx, path = cmd[0], cmd[1]
        c, d = containers[cidx], channels[cidx]
        with c.op_lock:
            wd = workdir(d, path)
            if cmd[2] == "set":
                wd.set(cmd[3], cmd[4])
            elif cmd[2] == "delete":
                wd.delete(cmd[3])
            elif cmd[2] == "set_subdir_key":
                sub = wd.get_sub_directory(cmd[3]) or \
                    wd.create_sub_directory(cmd[3])
                sub.set(cmd[4], cmd[5])
            else:
                wd.clear()
    d0 = channels[0]
    _settle(containers,
            lambda: all(d.root.to_dict() == d0.root.to_dict()
                        for d in channels))
    return {"doc": "corpus-dir", "channel": "dir",
            "channel_type": "directory", "workload": "directory_merge",
            "seed": seed, "clients": 4,
            "live_state": d0.root.to_dict()}


def record_items(server, outdir: str, n_ops: int = 1200,
                 seed: int = 13, device=None) -> dict:
    """Two-client number-sequence session: value-run inserts and range
    removes (the items-lane workload, round 5)."""
    containers, (s1, s2) = _session(
        server, "corpus-items", "nums", "items", 2, device)
    rng = random.Random(seed)
    seqs = [(containers[0], s1), (containers[1], s2)]
    for i in range(n_ops):
        c, s = seqs[rng.randrange(2)]
        with c.op_lock:
            n = s.get_item_count()
            if rng.random() < 0.72 or n < 6:
                at = rng.randrange(n + 1)
                s.insert_range(at, [i, i + 0.5])
            else:
                a = rng.randrange(n - 2)
                s.remove_range(a, min(n, a + rng.randrange(1, 4)))
    _settle(containers, lambda: s1.get_items() == s2.get_items())
    return {"doc": "corpus-items", "channel": "nums",
            "channel_type": "items", "workload": "number_sequence",
            "seed": seed, "clients": 2,
            "live_state": s1.get_items()}


def _refuse_pinned(outdir: str) -> None:
    from . import corpus as C
    real = os.path.realpath(outdir)
    pinned = os.path.realpath(C.CORPUS_DIR)
    if real == pinned or real.startswith(pinned + os.sep):
        raise ValueError(f"{outdir} holds the pinned corpora, which the "
                         "port replays and never writes")


def main(outdir: str, only: set | None = None, device=None,
         n_ops: int | None = None) -> dict:
    """Record every workload (or those in `only`) into `outdir` and write
    its pins.json there. `n_ops` overrides each recorder's op count.
    Returns the pins."""
    from ..server.tinylicious import DEFAULT_TENANT, Tinylicious
    from ..loader.drivers.routerlicious import RestWrapper
    from . import corpus as C

    _refuse_pinned(outdir)
    os.makedirs(outdir, exist_ok=True)
    pins_path = os.path.join(outdir, "pins.json")
    pins = {}
    if only and os.path.exists(pins_path):
        with open(pins_path) as f:
            pins = json.load(f)  # partial re-record keeps other pins
    recorders = (record_text, record_matrix, record_directory,
                 record_items)
    names = {r.__name__.removeprefix("record_") for r in recorders}
    if only and only - names:
        raise SystemExit(f"unknown --only names {sorted(only - names)}; "
                         f"choose from {sorted(names)}")
    sized = {} if n_ops is None else {"n_ops": n_ops}
    with Tinylicious() as server:
        rest = RestWrapper(server.url)
        for rec in recorders:
            name = rec.__name__.removeprefix("record_")
            if only and name not in only:
                continue
            header = rec(server, outdir, device=device, **sized)
            rows = rest.get(
                f"/deltas/{DEFAULT_TENANT}/{header['doc']}")["deltas"]
            live_state = header.pop("live_state")
            path = os.path.join(outdir, f"{header['workload']}.jsonl.gz")
            C.write_corpus(path, header, rows)
            # The pin must hold BOTH the recording and the replay
            # harness to the same truth: a fresh replica replaying the
            # written log must reach the live clients' end state.
            hdr, rrows = C.read_corpus(path)
            chan = C.replay(hdr, rrows, device=device)
            replay_state = C.channel_state(hdr["channel_type"], chan)
            if hdr["channel_type"] == "sequence":
                assert replay_state["text"] == live_state["text"], \
                    "replayed text diverges from the live session"
            else:
                assert replay_state == live_state, \
                    f"{header['workload']}: replay diverges from live"
            pins[header["workload"]] = {
                "file": os.path.basename(path),
                "digest": C.digest(replay_state),
                "ops": len(rows),
                "recorded": time.strftime("%Y-%m-%d"),
            }
            print(f"recorded {header['workload']}: {len(rows)} rows -> "
                  f"{pins[header['workload']]['digest'][:16]}...")
    with open(pins_path, "w") as f:
        json.dump(pins, f, indent=2, sort_keys=True)
    print(f"pins written to {pins_path}")
    return pins


if __name__ == "__main__":
    args = sys.argv[1:]
    only = {a.removeprefix("--only=") for a in args
            if a.startswith("--only=")}
    devices = [a.removeprefix("--device=") for a in args
               if a.startswith("--device=")]
    dirs = [a for a in args if not a.startswith("--")]
    if len(dirs) != 1:
        raise SystemExit("usage: python -m fluidframework_tpu_torch.testing."
                         "record_corpus OUTDIR [--only=NAME ...] "
                         "[--device=DEVICE]")
    main(dirs[0], only or None, devices[-1] if devices else None)
