"""Both packages' client-side modules, side by side, for the port's parity
tests (tests/test_torch_{framework,code_loading,drivers,offline_tools}.py).

`stack(package)` imports one package's modules under common names, with a
`Loader` and a `load` (Container.load) that put the port on the CPU
(device="cpu"; without it the port takes the card). `same(script)` runs
`script(stack)` through the JAX package and then the port under the same
pins (testing/client_runs.pinned: client ids, clocks, interval ids,
`random`, the forced bulk route) and requires equal results.
"""

import importlib
import json
from types import SimpleNamespace

from fluidframework_tpu_torch.testing import client_runs

PACKAGES = ("fluidframework_tpu", "fluidframework_tpu_torch")
MODULES = {
    "container": "loader.container", "delta_manager": "loader.delta_manager",
    "local_driver": "loader.drivers.local", "replay": "loader.drivers.replay",
    "file": "loader.drivers.file", "debug": "loader.drivers.debug",
    "url_resolver": "loader.drivers.url_resolver",
    "caching": "loader.drivers.caching", "proxy": "loader.drivers.proxy",
    "resilience": "loader.drivers.resilience",
    "code_loader": "loader.code_loader",
    "local_server": "server.local_server", "storage": "server.storage",
    "admission": "server.admission", "counters": "telemetry.counters",
    "messages": "protocol.messages", "summary": "protocol.summary",
    "sequence": "dds.sequence", "map": "dds.map", "matrix": "dds.matrix",
    "directory": "dds.directory", "summary_block": "dds.summary_block",
    "register_collection": "dds.register_collection",
    "framework": "framework", "data_object": "framework.data_object",
    "factories": "framework.container_factories",
    "client_api": "client_api", "hosts": "hosts", "tools": "tools",
    "replay_tool": "tools.replay_tool"}


def stack(package: str) -> SimpleNamespace:
    s = SimpleNamespace(**{k: importlib.import_module(f"{package}.{v}")
                           for k, v in MODULES.items()})
    s.name = package
    s.device = {"device": "cpu"} if package.endswith("_torch") else {}
    s.Loader = lambda *a, **k: s.container.Loader(*a, **k, **s.device)
    s.load = lambda *a, **k: s.container.Container.load(*a, **k, **s.device)
    return s


def same(script, seed: int = 7) -> list:
    """script(stack) through both packages, as JSON; the results must be
    equal. Returns them."""
    out = []
    for package in PACKAGES:
        s = stack(package)
        with client_runs.pinned(s, seed):
            out.append(json.dumps(script(s), sort_keys=True, default=str))
    assert out[1] == out[0]
    return [json.loads(o) for o in out]
