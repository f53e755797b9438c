"""The port's offline tools held to the JAX package's: a mirror of
tests/test_tools.py (the replay tool, the merge-tree client replay, the
fetch tool), captures carried across the two packages through the file
driver's format, the application scenario (testing/app_runs.py) against
its committed JAX golden (testing/golden/app_golden.json), and the faults
of the JAX package's offline path that the port repairs or keeps (ROADMAP
Queue 3), each shown in both packages.

Regenerate the golden only on a deliberate change of the scenario:

    JAX_PLATFORMS=cpu python tests/test_torch_offline_tools.py --write
"""

import importlib
import json
import os
import random
import sys

import pytest
import torch

from fluidframework_tpu_torch.testing import app_runs, client_runs, golden
from fluidframework_tpu_torch.testing.traces import keystroke_trace
from torch_stacks import PACKAGES, same, stack

torch.set_num_threads(1)


def jax_package() -> app_runs.AppPackage:
    from fluidframework_tpu import client_api, framework, hosts, tools
    from fluidframework_tpu.dds import directory, sequence, shared_object
    from fluidframework_tpu.loader import code_loader, delta_manager
    from fluidframework_tpu.loader.drivers import file, local
    from fluidframework_tpu.mergetree import client
    from fluidframework_tpu.protocol import summary
    from fluidframework_tpu.server import local_server, storage
    from fluidframework_tpu.testing import traces
    return app_runs.AppPackage(
        local_server, storage, delta_manager, sequence, summary, client,
        framework, code_loader, hosts, client_api, local, file, tools,
        traces, {}, directory, shared_object, None, reference=True)


# --- mirrors tests/test_tools.py -------------------------------------------

def record_session(s, n_rounds=6):
    """Two live clients edit; returns (factory, summary, ops, text)."""
    server = s.local_server.LocalServer()
    factory = s.local_driver.LocalDocumentServiceFactory(server)
    loader = s.Loader(factory)
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    text = ds.create_channel("t", s.sequence.SharedString.TYPE)
    meta = ds.create_channel("m", s.map.SharedMap.TYPE)
    c1.attach()
    c2 = loader.resolve("doc")
    t2 = c2.runtime.get_datastore("default").get_channel("t")
    rng = random.Random(7)
    for i in range(n_rounds):
        text.insert_text(rng.randrange(text.get_length() + 1), f"a{i}")
        t2.insert_text(rng.randrange(t2.get_length() + 1), f"B{i}")
        if i % 2:
            meta.set(f"k{i}", i)
    server.pump()
    summary = server.storage("doc").read_summary()
    ops = factory.create_document_service("doc") \
        .connect_to_delta_storage().get(0)
    assert text.get_text() == t2.get_text()
    return factory, summary, ops, text.get_text()


def tool(s, summary, ops):
    return s.tools.ReplayTool(summary, ops, **s.device)


def points(s, result) -> list:
    """The snapshot points in dict form (the packages' canonical strings
    differ: the port's coalesces acknowledged text)."""
    return [[p.sequence_number, s.summary.summary_tree_to_dict(p.summary)]
            for p in result.snapshots]


class TestReplayTool:
    def test_deterministic_end_to_end(self):
        def script(s):
            _, summary, ops, expected = record_session(s)
            result = tool(s, summary, ops).run(
                s.tools.ReplayArgs(validate_storage=True))
            assert result.deterministic, result.mismatches
            assert result.final_seq == ops[-1].sequence_number
            return [points(s, result), result.final_seq]
        same(script)

    def test_snap_freq_intermediate_snapshots(self):
        def script(s):
            _, summary, ops, _ = record_session(s)
            result = tool(s, summary, ops).run(
                s.tools.ReplayArgs(snap_freq=5, validate_storage=True))
            assert result.deterministic, result.mismatches
            assert len(result.snapshots) >= 2
            return points(s, result)
        same(script)

    def test_write_dir(self, tmp_path):
        def script(s):
            _, summary, ops, _ = record_session(s, 3)
            out = tmp_path / s.name
            result = tool(s, summary, ops).run(s.tools.ReplayArgs(
                validate_storage=False, write_dir=str(out)))
            snap_dir = out / f"snapshot_{result.final_seq}"
            assert (snap_dir / "summary.json").exists()
            return (snap_dir / "summary.json").read_text()
        same(script)


class TestMergeTreeReplayer:
    def test_convergent_log(self):
        def script(s):
            log = [
                {"op": {"type": 0, "pos1": 0, "seg": {"text": "hello"}},
                 "seq": 1, "refSeq": 0, "client": 1},
                {"op": {"type": 0, "pos1": 5, "seg": {"text": " world"}},
                 "seq": 2, "refSeq": 1, "client": 2},
                # Concurrent inserts at the same position (both refSeq 2).
                {"op": {"type": 0, "pos1": 0, "seg": {"text": "A"}},
                 "seq": 3, "refSeq": 2, "client": 1},
                {"op": {"type": 0, "pos1": 0, "seg": {"text": "B"}},
                 "seq": 4, "refSeq": 2, "client": 2},
                {"op": {"type": 1, "pos1": 1, "pos2": 3},
                 "seq": 5, "refSeq": 4, "client": 1},
            ]
            text = s.tools.MergeTreeReplayer().replay(log)
            assert "world" in text
            return text
        same(script)

    def test_divergence_detection(self):
        def script(s):
            replayer = s.tools.MergeTreeReplayer()
            replayer.replay([
                {"op": {"type": 0, "pos1": 0, "seg": {"text": "same"}},
                 "seq": 1, "refSeq": 0, "client": 1}])
            # Corrupt one replica behind the replayer's back.
            replayer.clients[1].tree.segments[0].text = "tampered"
            with pytest.raises(AssertionError, match="divergence"):
                replayer.assert_converged()
            return sorted(replayer.clients)
        same(script)

    def test_random_schedule_converges(self):
        def script(s):
            rng = random.Random(42)
            log, seq, length = [], 0, 0
            for _ in range(60):
                seq += 1
                client = rng.choice([1, 2, 3])
                ref = rng.randrange(max(1, seq - 3), seq) if seq > 1 else 1
                if length > 4 and rng.random() < 0.3:
                    start = rng.randrange(0, length - 2)
                    end = min(length, start + rng.randrange(1, 3))
                    log.append({"op": {"type": 1, "pos1": start,
                                       "pos2": end},
                                "seq": seq, "refSeq": ref - 1,
                                "client": client})
                    length -= (end - start)
                else:
                    pos = rng.randrange(0, length + 1)
                    txt = rng.choice("abcdef") * rng.randrange(1, 4)
                    log.append({"op": {"type": 0, "pos1": pos,
                                       "seg": {"text": txt}},
                                "seq": seq, "refSeq": ref - 1,
                                "client": client})
                    length += len(txt)
            # Positions were generated against the converged view, so a
            # replay with refSeq = seq-1 (no concurrency) must converge.
            for entry in log:
                entry["refSeq"] = entry["seq"] - 1
            return s.tools.MergeTreeReplayer().replay(log)
        same(script)


class TestFetchTool:
    def test_fetch_stats_and_capture(self, tmp_path):
        def script(s):
            factory, _, ops, expected = record_session(s)
            root = tmp_path / s.name
            out = str(root / "fetched")
            summary, fetched_ops, stats = s.tools.fetch_document(
                factory, "doc", out_dir=out)
            assert isinstance(stats, s.tools.FetchStats)
            assert stats.op_count == len(ops) > 0
            assert stats.ops_by_type.get("op", 0) > 0
            assert stats.summary_blob_count > 0
            assert "ops" in stats.report()
            assert os.path.exists(f"{out}/summary.json")
            assert os.path.exists(f"{out}/stats.json")
            # The capture reloads through the file driver to the same
            # state.
            c = s.Loader(s.file.FileDocumentServiceFactory(str(root))) \
                .resolve("fetched")
            t = c.runtime.get_datastore("default").get_channel("t")
            assert t.get_text() == expected
            return [stats.report(), stats.summary_paths,
                    len(stats.ops_by_client), (root / "fetched" /
                                               "stats.json").read_text()]
        same(script)


# --- captures carried across the packages ----------------------------------

def write_capture(s, out_dir):
    """A two-client session fetched into `out_dir` by package `s`."""
    factory, _, _, expected = record_session(s)
    s.tools.fetch_document(factory, "doc", out_dir=str(out_dir))
    return expected


def load_capture(s, root):
    c = s.Loader(s.file.FileDocumentServiceFactory(str(root))) \
        .resolve("doc")
    result = s.tools.ReplayTool.from_capture(str(root / "doc"), **s.device) \
        .run(s.tools.ReplayArgs(snap_freq=5))
    assert result.deterministic, result.mismatches
    return {"text": c.runtime.get_datastore("default").get_channel("t")
            .get_text(),
            "tree": s.summary.summary_tree_to_dict(c._assemble_summary()),
            "points": points(s, result), "final": result.final_seq}


@pytest.mark.parametrize("writer", PACKAGES)
def test_capture_loads_in_the_other_package(writer, tmp_path):
    """A capture one package's fetch tool writes loads in the other through
    the file driver and the replay tool, to equal canonical summaries; the
    files the two packages write are the same but for the messages'
    wall-clock timestamps."""
    captures = {}
    for package in PACKAGES:
        s = stack(package)
        with client_runs.pinned(s, 11):
            captures[package] = write_capture(s, tmp_path / package / "doc")
    assert captures[PACKAGES[0]] == captures[PACKAGES[1]]
    for name in ("summary.json", "stats.json"):
        assert (tmp_path / PACKAGES[0] / "doc" / name).read_bytes() == \
            (tmp_path / PACKAGES[1] / "doc" / name).read_bytes()
    ops = [[{k: v for k, v in m.items() if k != "timestamp"}
            for m in json.loads((tmp_path / p / "doc" / "ops.json")
                                .read_text())] for p in PACKAGES]
    assert ops[0] == ops[1]
    loaded = {}
    for package in PACKAGES:
        s = stack(package)
        with client_runs.pinned(s, 11):
            loaded[package] = load_capture(s, tmp_path / writer)
    assert loaded[PACKAGES[1]] == loaded[PACKAGES[0]]
    assert loaded[PACKAGES[1]]["text"] == captures[writer]


# --- the application scenario against its golden ---------------------------

class TestAppGolden:
    def test_golden_covers_the_path(self):
        """The golden's run reached the bulk path on both reloads, its
        replay is deterministic, and its reload equals both writers."""
        g = golden.load_app()
        assert g["mismatches"] == [] and g["loaded_equal"]
        assert g["bulk_applies"]["file_load"] >= 1
        assert g["bulk_applies"]["replay"] >= 1
        assert [p[0] for p in g["snapshots"]] == [500, 1000, 1500,
                                                  g["final_seq"]]
        assert g["ops"] == g["fetch"]["op_count"] == g["final_seq"]

    def test_jax_matches_golden(self):
        """The JAX package (with app_runs.reference_pins) gives the golden,
        and the run restores every module it pins."""
        pkg = jax_package()
        before = (pkg.client.MergeTreeClient.apply_bulk,
                  pkg.tools.replay_tool.Container,
                  pkg.tools.replay_tool.canonical_summary,
                  pkg.directory.SubDirectory.to_dict,
                  os.environ.get("FLUID_TPU_FORCE_BULK"))
        state = random.getstate()
        assert app_runs.run(pkg) == golden.load_app()
        assert (pkg.client.MergeTreeClient.apply_bulk,
                pkg.tools.replay_tool.Container,
                pkg.tools.replay_tool.canonical_summary,
                pkg.directory.SubDirectory.to_dict,
                os.environ.get("FLUID_TPU_FORCE_BULK")) == before
        assert random.getstate() == state

    def test_port_matches_golden(self):
        got, launches = app_runs.run_counted(app_runs.port_package("cpu"))
        assert got == golden.load_app()
        assert launches == {"file_load": 0, "replay": 0}  # no card here


# --- the JAX package's faults on this path (ROADMAP Queue 3) ---------------

def typed_document(s, n_ops=120, comment_at=20):
    """One client types `n_ops` ops of the keystroke trace into a string
    created after the attach summary, and a second adds and deletes a
    comment before op `comment_at` (testing/app_runs.comment), so a reload
    takes the bulk path. Returns (summary, ops, text)."""
    server = s.local_server.LocalServer()
    factory = s.local_driver.LocalDocumentServiceFactory(server)
    loader = s.Loader(factory)
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    c1.attach()
    t = ds.create_channel("t", s.sequence.SharedString.TYPE)
    c2 = loader.resolve("doc")
    t2 = c2.runtime.get_datastore("default").get_channel("t")
    for i, (op, *_) in enumerate(keystroke_trace(n_ops, seed=5)):
        if i == comment_at:
            app_runs.comment(t2, server)
        app_runs.apply_trace_op(t, op)
    server.pump()
    ops = factory.create_document_service("doc") \
        .connect_to_delta_storage().get(0)
    return server.storage("doc").read_summary(), ops, t.get_text()


def test_reference_replay_tool_submits_on_a_read_only_connection():
    """fluidframework_tpu/tools/replay_tool.py ReplayTool.run: its
    containers load without client details, so after 25 remote ops
    (DeltaManager.noop_threshold) the delta manager submits a NO_OP on the
    read-only replay connection, which raises PermissionError out of run().
    The port loads them read-only and replays."""
    results = {}
    for package in PACKAGES:
        s = stack(package)
        with client_runs.pinned(s, 2):
            summary, ops, text = typed_document(s, n_ops=40, comment_at=99)
            run = lambda: tool(s, summary, ops).run(  # noqa: E731
                s.tools.ReplayArgs(snap_freq=10))
            if package == PACKAGES[0]:
                with pytest.raises(PermissionError, match="read-only"):
                    run()
            else:
                result = run()
                assert result.deterministic and len(result.snapshots) == 5
                results[package] = result
    assert not hasattr(importlib.import_module(
        "fluidframework_tpu.tools.replay_tool"), "CLIENT_DETAILS")


def test_reference_directory_cannot_summarize_a_handle():
    """fluidframework_tpu/dds/directory.py SharedDirectory.summarize_core:
    a root holding a FluidHandle (a DataObject keeping a channel's handle)
    makes json.dumps raise TypeError at every summary. The port writes the
    handle's wire form, which loads back as a handle."""
    for package in PACKAGES:
        s = stack(package)
        with client_runs.pinned(s, 2):
            server = s.local_server.LocalServer()
            loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(
                server))
            c = loader.create_detached("doc")
            ds = c.runtime.create_datastore("default")
            root = ds.create_channel("root",
                                     s.directory.SharedDirectory.TYPE)
            c.attach()
            text = ds.create_channel("t", s.sequence.SharedString.TYPE)
            root.set("text", text.handle)
            if package == PACKAGES[0]:
                with pytest.raises(TypeError, match="FluidHandle"):
                    c._assemble_summary()
            else:
                tree = s.summary.summary_tree_to_dict(c._assemble_summary())
                header = tree["entries"][".app"]["entries"][".dataStores"][
                    "entries"]["default"]["entries"][".channels"]["entries"][
                    "root"]["entries"]["header"]["content"]
                assert json.loads(header)["storage"]["text"] == {
                    "type": "__fluid_handle__", "url": "/default/t"}
                c2 = loader.resolve("doc")
                handle = c2.runtime.get_datastore("default") \
                    .get_channel("root").get("text")
                assert handle.absolute_path == "/default/t"


def test_reference_storage_check_compares_segment_boundaries():
    """fluidframework_tpu/tools/replay_tool.py canonical_summary: summaries
    compare byte for byte, segment boundaries included. A straight load
    whose tail takes the bulk catch-up and a snapshot-plus-tail replay
    reach the same text with different boundaries, so the reference tool
    reports a divergence at every snapshot point (its containers loaded
    read-only here, past the fault above); the port's canonical form
    coalesces acknowledged text and reports none."""
    mismatches = {}
    for package in PACKAGES:
        s = stack(package)
        with client_runs.pinned(s, 2):
            summary, ops, text = typed_document(s)
            t = s.replay_tool
            container = t.Container

            class ReadOnly(container):
                @staticmethod
                def load(doc, service, *a, **k):
                    k.setdefault("client_details", {"mode": "read"})
                    return container.load(doc, service, *a, **k)

            t.Container = ReadOnly
            try:
                result = tool(s, summary, ops).run(
                    s.tools.ReplayArgs(snap_freq=50))
            finally:
                t.Container = container
            mismatches[package] = result.mismatches
    assert mismatches[PACKAGES[1]] == []
    assert mismatches[PACKAGES[0]] and all(
        "storage replay divergence" in m for m in mismatches[PACKAGES[0]])


def test_storage_check_failure_is_recorded_not_raised(monkeypatch):
    """Both packages' ReplayTool._validate_from_snapshot catch Exception
    and record it as a mismatch: the tool reports, so a caller must require
    `deterministic` (kept in the port)."""
    def script(s):
        _, summary, ops, _ = record_session(s)
        t = s.replay_tool
        container = t.Container

        class Failing(container):
            @staticmethod
            def load(doc, service, *a, **k):
                if doc == "replay-check":
                    raise RuntimeError("storage is gone")
                return container.load(doc, service, *a, **k)

        monkeypatch.setattr(t, "Container", Failing)
        result = tool(s, summary, ops).run(s.tools.ReplayArgs(snap_freq=5))
        monkeypatch.setattr(t, "Container", container)
        assert not result.deterministic
        assert all("storage replay failed" in m and "storage is gone" in m
                   for m in result.mismatches)
        return result.mismatches
    same(script)


def test_replay_tool_defaults_to_the_card(monkeypatch, tmp_path):
    """ReplayTool and ReplayTool.from_capture take the card by default and
    raise without CUDA; device="cpu" loads every container there."""
    s = stack(PACKAGES[1])
    with client_runs.pinned(s, 1):
        factory, summary, ops, _ = record_session(s)
        s.tools.fetch_document(factory, "doc", out_dir=str(tmp_path / "doc"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        s.tools.ReplayTool(summary, ops)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        s.tools.ReplayTool.from_capture(str(tmp_path / "doc"))
    assert s.tools.ReplayTool.from_capture(
        str(tmp_path / "doc"), device="cpu").device.type == "cpu"


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_offline_tools.py --write")
    from fluidframework_tpu.core.platform import force_host_platform
    force_host_platform(1)
    golden.save_app(app_runs.run(jax_package()))
    print(f"wrote {golden.APP_GOLDEN_PATH} "
          f"({golden.APP_GOLDEN_PATH.stat().st_size} bytes)")
