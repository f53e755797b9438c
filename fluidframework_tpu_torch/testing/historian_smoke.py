"""Historian smoke: spin up the local topology WITH the cache tier and
prove the end-to-end contract in one command (`make historian-smoke`).

Topology: tinylicious alfred + standalone HistorianService (proxy mode)
+ ServiceMonitor, a container created and attached through the network
driver's historian endpoint, then reloaded. Asserts:
  1. the reload serves its summary blobs from the tier (hit rate > 0,
     visible through monitor.py's /metrics),
  2. a summary commit invalidated the tier's ref pointer (write-through),
  3. killing the historian degrades the next load to direct GitStore
     reads without failing.
Exit code 0 = all held.

The containers load through a Loader on `device` (None means the card,
which raises without CUDA); the monitor takes the same device.

Usage: python -m fluidframework_tpu_torch.testing.historian_smoke
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def main(device=None) -> int:
    from ..core.device import resolve_device
    from ..dds.map import SharedMap
    from ..loader.container import Loader
    from ..loader.drivers.routerlicious import NetworkDocumentServiceFactory
    from ..server.historian import HistorianService
    from ..server.monitor import ServiceMonitor
    from ..server.tinylicious import DEFAULT_TENANT, Tinylicious

    device = resolve_device(device)

    def load(tiny, hist, doc_id):
        factory = NetworkDocumentServiceFactory(
            tiny.url, DEFAULT_TENANT, historian_url=hist.url)
        return Loader(factory, device=device).resolve(doc_id)

    with Tinylicious() as tiny:
        hist = HistorianService(upstream_url=tiny.url).start()
        tiny.attach_historian(hist.url)
        monitor = ServiceMonitor(device=device)
        monitor.watch_historian("historian", hist)
        monitor.start()
        print(f"historian-smoke: alfred={tiny.url} historian={hist.url} "
              f"monitor={monitor.url}")

        factory = NetworkDocumentServiceFactory(
            tiny.url, DEFAULT_TENANT, historian_url=hist.url)
        loader = Loader(factory, device=device)
        c1 = loader.create_detached("smoke")
        ds = c1.runtime.create_datastore("default")
        m = ds.create_channel("root", SharedMap.TYPE)
        with c1.op_lock:
            m.set("k", "v1")
        c1.attach()  # write-through upload + warm-on-summary prefetch

        c2 = load(tiny, hist, "smoke")
        assert c2.runtime.get_datastore("default") \
            .get_channel("root").get("k") == "v1"
        report = json.loads(urllib.request.urlopen(
            monitor.url + "/metrics").read())
        probe = report["probes"]["historian"]
        hit_rate = probe["objects"]["hitRate"]
        print(f"historian-smoke: reload hit rate "
              f"{hit_rate:.2f} ({probe['objects']['hits']} hits, "
              f"{probe['objects']['misses']} misses, "
              f"{probe['prefetchedObjects']} prefetched)")
        assert probe["objects"]["hits"] > 0, "reload never hit the cache"
        assert hit_rate > 0, "hit rate not visible through monitor"
        assert probe["invalidations"] >= 1, \
            "summary commit never invalidated the ref pointer"

        hist.stop()
        c3 = load(tiny, hist, "smoke")
        assert c3.runtime.get_datastore("default") \
            .get_channel("root").get("k") == "v1"
        print("historian-smoke: degradation to direct GitStore OK")
        for c in (c1, c2, c3):
            c.close()
        monitor.stop()
    print("historian-smoke: PASS")
    return 0


if __name__ == "__main__":
    _ap = argparse.ArgumentParser(prog="historian_smoke")
    _ap.add_argument("--device", default=None)
    sys.exit(main(_ap.parse_args().device))
