"""The port's local server against the JAX package's on the CPU, with
zero tolerance: testing/server_runs.py's scenario at its small size
(golden.SERVER_SMALL: 16 documents, 3 waves, 2 partitions, 2 broadcaster
shards) through the JAX TpuLocalServer and the port's
TpuLocalServer(device="cpu"), bucketed, paged and with the overlapped
lambda runner, and through both packages' LocalServer (the scalar deli).

Every digest must be equal: each reader's stream in order, each writer's
nacks, the delta store, the channel texts, the scribe's checkpoints, the
summary commits' trees, the catch-up artifacts and the materialized
snapshots' trees. The scenario needs no admission nack, acks every
summary and (on the device path) publishes the catch-up documents.
"""

import pytest

from fluidframework_tpu_torch.testing import golden, server_runs


def jax_package():
    from fluidframework_tpu.protocol import messages, summary
    from fluidframework_tpu.server import local_server, storage
    return server_runs.ServerPackage(local_server, storage, messages,
                                     summary, {})


def port_package():
    return server_runs.port_package("cpu")


SMALL = server_runs.Spec(**golden.SERVER_SMALL)


@pytest.mark.parametrize("variant", sorted(server_runs.VARIANTS))
def test_port_equals_jax(variant):
    kw = server_runs.VARIANTS[variant]
    want = server_runs.run(jax_package(), SMALL, **kw)
    got = server_runs.run(port_package(), SMALL, **kw)
    for key in want:
        assert got[key] == want[key], key
    assert got["admission_nacks"] == 0 and got["nack_count"] == 0
    assert got["shed"] == 0
    assert got["readers"] == 4 and got["reader_messages"] > 0
    assert got["summaries_acked"] == 4
    if kw.get("tpu", True):
        assert got["catchup_docs"] == 4
        assert got["materialized_docs"] == SMALL.docs
    if variant == "bucketed":
        assert got["promoted"] > 0


def test_pinned_ids_and_clock_are_restored():
    """The run pins the package's client ids and commit clock and puts
    both back."""
    pkg = port_package()
    before = (pkg.local_server.uuid, pkg.storage.time)
    server_runs.run(pkg, SMALL._replace(docs=2, warm=0, measured=1,
                                        extra=0), tpu=False)
    assert (pkg.local_server.uuid, pkg.storage.time) == before
