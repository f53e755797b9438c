"""The load test and the headless agents over a TpuLocalServer, run the
same way on either package.

`keystroke_load` drives testing/load_test.LoadRunner in keystroke-trace
mode with reconnect churn against a TpuLocalServer; every replica must
converge and the server's own channel text must equal the clients'.
`agents_run` hosts the IntelligenceRunner on two HeadlessAgentRunners
over a TpuLocalServer while a writer edits the document's string: one
runner wins the task and publishes the insights every client reads.
Each returns what the other package must reproduce: the texts' digest,
or the insights (with the runner's client id, which carries a random
suffix, replaced by whether it names the winner).

A `ClientPackage` names one package's modules; `port_package(device)`
loads the port's (device None means the card, which raises without
CUDA). chip_smoke.py phase 22 (b) and (c) run the card sizes;
tests/test_torch_capacity_golden.py writes the JAX package's results into
testing/golden/capacity_golden.json.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, NamedTuple

# The keystroke load: documents x clients x ops, seeded, with reconnects.
LOAD_SMALL = dict(documents=2, clients_per_document=3, ops_per_client=40,
                  seed=11, reconnect_probability=0.05)
LOAD_CARD = dict(documents=4, clients_per_document=3, ops_per_client=150,
                 seed=11, reconnect_probability=0.05)
# The agents' document: the writer's edits, in order (position, text).
AGENT_EDITS = ((0, "The ocean was great. "), (0, "Waves broke "),
               (12, "on the shore, "), (0, "A wonderful, happy day! "),
               (5, "terrible "), (30, "ocean ocean waves. "))


class ClientPackage(NamedTuple):
    local_server: Any     # server/local_server module
    container: Any        # loader/container module
    local_driver: Any     # loader/drivers/local module
    load_test: Any        # testing/load_test module
    agents: Any           # agents package
    dds: Any              # dds package (map, sequence, register_collection)
    scheduler: Any        # framework/agent_scheduler module
    kwargs: dict          # device=... for the port's server and Loader


def port_package(device) -> ClientPackage:
    from .. import agents, dds
    from ..dds import map, register_collection, sequence  # noqa: F401
    from ..framework import agent_scheduler
    from ..loader import container
    from ..loader.drivers import local
    from ..server import local_server
    from . import load_test
    return ClientPackage(local_server, container, local, load_test, agents,
                         dds, agent_scheduler, {"device": device})


def _server(pkg: ClientPackage):
    return pkg.local_server.TpuLocalServer(**pkg.kwargs)


def _loader(pkg: ClientPackage, server):
    return pkg.container.Loader(
        pkg.local_driver.LocalDocumentServiceFactory(server), **pkg.kwargs)


def texts_digest(texts: dict) -> str:
    return hashlib.sha256(json.dumps(texts, sort_keys=True).encode()
                          ).hexdigest()


def keystroke_load(pkg: ClientPackage, profile: dict) -> dict:
    """LoadRunner in keystroke-trace mode over a TpuLocalServer. Raises
    AssertionError when a replica diverges or the server's channel text
    differs from a client's."""
    server = _server(pkg)
    runner = pkg.load_test.LoadRunner(lambda: _loader(pkg, server))
    result = runner.run(pkg.load_test.LoadProfile(keystroke_trace=True,
                                                  **profile))
    assert result.converged, result.divergences
    assert result.total_ops == profile["documents"] * \
        profile["clients_per_document"] * profile["ops_per_client"]
    server.pump()
    sq = server.sequencer()
    texts = {}
    for d in range(profile["documents"]):
        doc_id = f"load-doc-{d}"
        text = _loader(pkg, server).resolve(doc_id).runtime.get_datastore(
            "load").get_channel("text").get_text()
        served = sq.channel_text(doc_id, "load", "text")
        assert served == text, (doc_id, len(served), len(text))
        texts[doc_id] = text
    return {"texts_digest": texts_digest(texts),
            "chars": sum(len(t) for t in texts.values()),
            "total_ops": result.total_ops, "elapsed_s": result.elapsed_s}


def agents_run(pkg: ClientPackage) -> dict:
    """Two HeadlessAgentRunners host the IntelligenceRunner on one
    document while a writer edits its string. Raises AssertionError
    unless exactly one runner wins and every client reads the same
    insights."""
    server = _server(pkg)
    writer = _loader(pkg, server).create_detached("agents-doc")
    ds = writer.runtime.create_datastore("default")
    text = ds.create_channel("text", pkg.dds.sequence.SharedString.TYPE)
    ds.create_channel("insights", pkg.dds.map.SharedMap.TYPE)
    ds.create_channel(
        "tasks", pkg.dds.register_collection.ConsensusRegisterCollection.TYPE)
    writer.attach()
    server.pump()
    agents = []

    def intelligence(container):
        cds = container.runtime.get_datastore("default")
        agent = pkg.agents.IntelligenceRunner(
            pkg.scheduler.AgentScheduler(container, cds.get_channel("tasks")),
            cds.get_channel("text"), cds.get_channel("insights"))
        agents.append(agent)
        return agent

    runners = [pkg.agents.HeadlessAgentRunner(_loader(pkg, server),
                                              worker_id=f"headless-{i}")
               for i in range(2)]
    for runner in runners:
        runner.launch("agents-doc", [intelligence])
        server.pump()
    for pos, chunk in AGENT_EDITS:
        text.insert_text(pos, chunk)
        server.pump()
    winners = [a.is_runner for a in agents]
    assert winners.count(True) == 1, winners
    winner_id = agents[winners.index(True)].scheduler.container \
        .delta_manager.client_id
    views = []
    for container in [writer] + [r.documents["agents-doc"].container
                                 for r in runners]:
        m = container.runtime.get_datastore("default").get_channel(
            "insights")
        view = {k: m.get(k) for k in sorted(m.keys())}
        view["meta"] = dict(view["meta"],
                            runner=view["meta"]["runner"] == winner_id)
        views.append(view)
    assert all(v == views[0] for v in views), views
    runs = [a.runs for a in agents]
    for runner in runners:
        runner.close_all()
    return {"insights": json.loads(json.dumps(views[0])),
            "winner": winners.index(True), "runs": runs,
            "text": text.get_text()}
