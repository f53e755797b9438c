"""The port's C++ message log (fluidframework_tpu_torch/native/oplog.py over
native/src/oplog.cpp): a mirror of tests/test_native_oplog.py (engine
parity with the Python MessageLog, and the full stack running over it),
then the port against the JAX package's engine on the same seeded stream,
and the local server's scenario over it against the JAX server over its
own.

The engine builds with g++ at first use and nothing falls back: where the
JAX file skips without a toolchain, these tests build (g++ is part of the
toolchain the port needs for its wire pump too). The JAX file's
test_factory_fallback pinned native=False to the Python engine; here
test_factory_native_by_default holds that and that native=None and
native=True give the C++ engine.
"""

import random

import pytest

from fluidframework_tpu_torch.native import oplog
from fluidframework_tpu_torch.native.oplog import NativeMessageLog
from fluidframework_tpu_torch.server.log import MessageLog, make_message_log


class TestNativeEngine:
    def make(self):
        return NativeMessageLog(default_partitions=1)

    def test_append_poll_commit_cycle(self):
        log = self.make()
        for i in range(5):
            log.send("t", "doc", {"i": i})
        msgs = log.poll("g", "t", 0, limit=3)
        assert [m.value["i"] for m in msgs] == [0, 1, 2]
        assert [m.offset for m in msgs] == [0, 1, 2]
        log.commit("g", "t", 0, msgs[-1].offset)
        msgs = log.poll("g", "t", 0)
        assert [m.value["i"] for m in msgs] == [3, 4]
        # Commits never move backwards.
        log.commit("g", "t", 0, 0)
        assert log.committed("g", "t", 0) == 3

    def test_independent_consumer_groups(self):
        log = self.make()
        log.send("t", "k", "a")
        log.send("t", "k", "b")
        assert len(log.poll("g1", "t", 0)) == 2
        log.commit("g1", "t", 0, 1)
        assert len(log.poll("g1", "t", 0)) == 0
        assert len(log.poll("g2", "t", 0)) == 2

    def test_keyed_partitioning_stable(self):
        log = NativeMessageLog(default_partitions=4)
        m1 = log.send("t", "docA", 1)
        m2 = log.send("t", "docA", 2)
        assert m1.partition == m2.partition
        log2 = NativeMessageLog(default_partitions=4)
        assert log2.send("t", "docA", 3).partition == m1.partition

    def test_partition_views_and_subscribe(self):
        log = self.make()
        seen = []
        log.subscribe("t", 0, seen.append)
        log.send("t", "k", {"x": 1})
        assert len(seen) == 1 and seen[0].value == {"x": 1}
        view = log.topic("t").partitions[0]
        assert view.end_offset == 1
        assert view.read(0)[0].value == {"x": 1}

    def test_large_payload_grows_buffer(self):
        log = self.make()
        big = "x" * (3 << 20)
        log.send("t", "k", big)
        msgs = log.poll("g", "t", 0)
        assert msgs[0].value == big

    def test_parity_with_python_engine(self):
        ops = [("send", "a", i) for i in range(20)]
        results = []
        for log in (MessageLog(1), NativeMessageLog(1)):
            for _, key, val in ops:
                log.send("t", key, val)
            polled = log.poll("g", "t", 0, limit=7)
            log.commit("g", "t", 0, polled[-1].offset)
            polled2 = log.poll("g", "t", 0, limit=1000)
            results.append([(m.offset, m.value) for m in polled + polled2])
        assert results[0] == results[1]


class TestE2EOverNativeLog:
    def test_full_stack(self):
        """The JAX client stack over the port's LocalServer(native_log=
        True) on the CPU (summaries re-encoded into the port's classes,
        as in tests/test_torch_local_server_serving.py)."""
        from test_torch_local_server_serving import with_foreign_storage

        from fluidframework_tpu.dds.sequence import SharedString
        from fluidframework_tpu.loader.container import Loader
        from fluidframework_tpu.loader.drivers.local import (
            LocalDocumentServiceFactory,
        )
        from fluidframework_tpu_torch.server.local_server import LocalServer

        server = with_foreign_storage(LocalServer(native_log=True))
        assert isinstance(server.log, NativeMessageLog)
        loader = Loader(LocalDocumentServiceFactory(server))
        c1 = loader.create_detached("doc")
        ds1 = c1.runtime.create_datastore("default")
        text = ds1.create_channel("t", SharedString.TYPE)
        text.insert_text(0, "native")
        c1.attach()
        c2 = loader.resolve("doc")
        t2 = c2.runtime.get_datastore("default").get_channel("t")
        t2.insert_text(6, " broker")
        assert text.get_text() == t2.get_text() == "native broker"
        # Summarize flow over the native log.
        acks = []
        c1.summarize(lambda h, ack, c: acks.append(ack))
        server.pump()
        assert acks == [True]


def test_factory_native_by_default():
    """native=False pins the Python engine; native=None (the default) and
    native=True build the C++ engine and use it."""
    log = make_message_log(native=False)
    assert isinstance(log, MessageLog)
    assert isinstance(make_message_log(2), NativeMessageLog)
    assert isinstance(make_message_log(native=True), NativeMessageLog)


def test_failed_build_raises(monkeypatch):
    """No fallback: a library that cannot be built or loaded raises from
    the factory and from the server that asks for it."""
    from fluidframework_tpu_torch.native.build import NativeBuildError
    from fluidframework_tpu_torch.server.local_server import LocalServer

    def refuse(name, force=False):
        raise NativeBuildError(f"no compiler for {name}")

    monkeypatch.setattr(oplog, "_LIB", None)
    monkeypatch.setattr(oplog, "ensure_built", refuse)
    with pytest.raises(NativeBuildError, match="oplog"):
        make_message_log()
    with pytest.raises(NativeBuildError, match="oplog"):
        LocalServer(native_log=True)
    assert isinstance(make_message_log(native=False), MessageLog)


def _stream(log, seed: int) -> list:
    """A seeded append / poll / commit / subscribe / read stream over a
    log of either package; returns what a consumer can observe (offsets,
    partitions, keys, payloads, commits, end offsets)."""
    rng = random.Random(seed)
    seen = []
    log.subscribe("deltas", 1, lambda m: seen.append(
        ("sub", m.partition, m.offset, m.key, m.value)))
    out = []
    for i in range(300):
        r = rng.random()
        topic = rng.choice(["rawdeltas", "deltas"])
        key = f"doc{rng.randrange(12)}"
        value = {"i": i, "text": "x" * rng.randrange(40),
                 "n": [rng.randrange(9) for _ in range(rng.randrange(4))]}
        if r < 0.45:
            m = log.send(topic, key, value)
            out.append(("send", m.topic, m.partition, m.offset, m.key))
        elif r < 0.65:
            part = rng.randrange(3)
            m = log.send_to(topic, part, key, value)
            out.append(("send_to", m.partition, m.offset))
        elif r < 0.72:
            ms = log.send_to_many(topic, rng.randrange(3),
                                  [(key, value), (key + "b", i)])
            out.append(("many", [(m.partition, m.offset) for m in ms]))
        elif r < 0.86:
            part = rng.randrange(3)
            ms = log.poll("g", topic, part, limit=rng.randrange(1, 9))
            out.append(("poll", part, [(m.offset, m.key, m.value)
                                       for m in ms]))
            if ms and rng.random() < 0.7:
                log.commit("g", topic, part, ms[-1].offset)
        elif r < 0.93:
            part = rng.randrange(3)
            ms = log.read_from(topic, part, rng.randrange(6), limit=4)
            out.append(("read", part, [(m.offset, m.value) for m in ms]))
        else:
            log.commit_many("g2", topic, {p: rng.randrange(5)
                                          for p in range(3)})
            out.append(("committed", [log.committed(g, topic, p)
                                      for g in ("g", "g2")
                                      for p in range(3)]))
    out.append(("ends", [log.topic(t).partitions[p].end_offset
                         for t in ("rawdeltas", "deltas")
                         for p in range(3)]))
    return out + seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_log_equals_jax_engine(seed):
    """Offsets, FNV-1a partitions, payloads and commits of the port's C++
    engine equal the JAX package's on the same seeded stream (payloads
    compared by content: each package pickles its own classes)."""
    from fluidframework_tpu.native.oplog import \
        NativeMessageLog as JaxNativeMessageLog
    assert _stream(NativeMessageLog(3), seed) == \
        _stream(JaxNativeMessageLog(3), seed)


@pytest.mark.parametrize("variant", ["bucketed", "scalar"])
def test_server_scenario_over_native_log_equals_jax(variant):
    """testing/server_runs.py at its tier-1 size over the C++ log: every
    digest equals the JAX server's over its own C++ log, and the committed
    golden's (made over the Python log: the log engine changes no
    per-document result, since the server routes documents itself)."""
    from test_torch_local_server import jax_package, port_package

    from fluidframework_tpu_torch.testing import golden, server_runs
    spec = server_runs.Spec(**golden.SERVER_SMALL)
    kw = server_runs.VARIANTS[variant]
    got = server_runs.run(port_package(), spec, native_log=True, **kw)
    assert got == server_runs.run(jax_package(), spec, native_log=True,
                                  **kw)
    assert got == golden.load_server()["small"][variant]
