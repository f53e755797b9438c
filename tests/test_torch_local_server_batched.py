"""Batched-window serving on the port's local server, driven by the JAX
package's client stack: a mirror of tests/test_tpu_batched_windows.py.

With auto_pump off, ops accumulate in the raw topic and the port's device
sequencer (on the CPU here) drains them as REAL multi-op windows (T
buckets 4/16/64). Convergence and server materialization must hold
identically. The servers come from tests/test_torch_local_server_serving.py
(the port's TpuLocalServer(device="cpu") and LocalServer, with the storage
wrapper that takes the JAX container's summary trees)."""

import random

from fluidframework_tpu.dds.counter import SharedCounter
from fluidframework_tpu.dds.map import SharedMap
from fluidframework_tpu.dds.sequence import SharedString
from fluidframework_tpu.loader.container import Loader
from fluidframework_tpu.loader.drivers.local import LocalDocumentServiceFactory

from test_torch_local_server_serving import (  # noqa: F401 — fixture
    LocalServer, TpuLocalServer, isolate_port_histograms)


class TestBatchedWindows:
    def _run(self, server_cls, seed=5, docs=3, rounds=12, burst=9):
        """Multi-doc, multi-client traffic pumped in BURSTS: each round
        queues `burst` ops per document before one pump drains them all —
        every flush sequences a multi-message window per doc."""
        rng = random.Random(seed)
        server = server_cls(auto_pump=False)
        loader = Loader(LocalDocumentServiceFactory(server))
        channels = {}
        for d in range(docs):
            doc = f"doc{d}"
            c = loader.create_detached(doc)
            ds = c.runtime.create_datastore("default")
            texts = [ds.create_channel("text", SharedString.TYPE)]
            maps = [ds.create_channel("kv", SharedMap.TYPE)]
            counters = [ds.create_channel("n", SharedCounter.TYPE)]
            c.attach()
            server.pump()
            c2 = loader.resolve(doc)
            ds2 = c2.runtime.get_datastore("default")
            texts.append(ds2.get_channel("text"))
            maps.append(ds2.get_channel("kv"))
            counters.append(ds2.get_channel("n"))
            channels[doc] = (texts, maps, counters)
            server.pump()

        for _ in range(rounds):
            for doc, (texts, maps, counters) in channels.items():
                for _ in range(burst):
                    which = rng.random()
                    i = rng.randrange(2)
                    if which < 0.5:
                        t = texts[i]
                        n = t.get_length()
                        if n > 4 and rng.random() < 0.3:
                            a = rng.randrange(n - 1)
                            t.remove_text(a, min(n, a + 2))
                        else:
                            t.insert_text(rng.randrange(n + 1) if n else 0,
                                          f"{doc[-1]}{rng.randrange(10)}")
                    elif which < 0.8:
                        maps[i].set(f"k{rng.randrange(5)}", rng.randrange(99))
                    else:
                        counters[i].increment(1)
            server.pump()  # one drain: multi-op windows per doc
        server.pump()
        return server, channels

    def test_tpu_batched_matches_scalar_batched(self):
        out = {}
        for cls in (LocalServer, TpuLocalServer):
            server, channels = self._run(cls)
            state = {}
            for doc, (texts, maps, counters) in channels.items():
                assert texts[0].get_text() == texts[1].get_text(), doc
                assert counters[0].value == counters[1].value, doc
                assert {k: maps[0].get(k) for k in maps[0].keys()} == \
                    {k: maps[1].get(k) for k in maps[1].keys()}, doc
                state[doc] = (
                    texts[0].get_text(),
                    {k: maps[0].get(k) for k in sorted(maps[0].keys())},
                    counters[0].value)
            out[cls.__name__] = state
        assert out["LocalServer"] == out["TpuLocalServer"]

    def test_server_materialization_after_batched_windows(self):
        server, channels = self._run(TpuLocalServer, seed=9)
        seq = server.sequencer()
        for doc, (texts, maps, counters) in channels.items():
            assert seq.channel_text(doc, "default", "text") == \
                texts[0].get_text()
            snap = seq.channel_snapshot(doc, "default", "kv")
            assert snap["entries"] == {
                k: maps[0].get(k) for k in maps[0].keys()}
            assert seq.channel_snapshot(doc, "default", "n")["counter"] == \
                counters[0].value
