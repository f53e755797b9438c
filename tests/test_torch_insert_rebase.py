"""Two clients of an items sequence converge when a local insert skipped
tombstones that a concurrent remote insert lands in front of.

A local insert skips the acked tombstones at its boundary. A remote insert
sequenced before it, but made at an older refSeq, can land in front of
those tombstones; the sequenced replicas then put the local insert in
front of the remote one, and so must its author
(MergeTreeOracle._rebase_pending_inserts). The scripted interleavings
below are the smallest that showed the fault (a fuzz of two-client
sessions); the second also has the client's own pending remove
overwritten by a remote remove. Each is run through the port's
MergeTreeClient and through the JAX package's: the sequenced replicas of
the two packages agree, every port client reaches them, and the JAX
package's client keeps the fault (its order is pinned here).
"""

import random

import pytest

from fluidframework_tpu.mergetree.client import \
    MergeTreeClient as JaxClient
from fluidframework_tpu_torch.mergetree.client import MergeTreeClient

INS, REM = "insert", "remove"

# (event, client, op): "local" makes an op on the client's current view,
# sequenced at once (refSeq = the last seq the client has applied);
# "deliver" applies the client's next sequenced message. Whatever is left
# is delivered at the end.
TOMBSTONE_SKIP = [
    ("local", 0, (INS, 0)), ("deliver", 1, None), ("local", 1, (INS, 1)),
    ("deliver", 1, None), ("local", 1, (REM, 1, 2)),
    ("local", 0, (INS, 1)), ("deliver", 1, None), ("local", 1, (INS, 1)),
]
OVERWRITTEN_REMOVE = [
    ("local", 1, (INS, 0)), ("deliver", 1, None), ("local", 1, (INS, 0)),
    ("deliver", 0, None), ("deliver", 1, None), ("local", 1, (REM, 0, 2)),
    ("local", 1, (INS, 0)), ("local", 0, (INS, 1)), ("deliver", 1, None),
    ("local", 1, (INS, 2)), ("local", 0, (INS, 1)), ("deliver", 1, None),
    ("deliver", 0, None), ("deliver", 1, None), ("local", 0, (INS, 1)),
    ("local", 0, (REM, 0, 2)),
]
CASES = {
    "tombstone_skip": (TOMBSTONE_SKIP, [0, 4, 4.5, 3, 3.5, 1.5, 0.5],
                       {1: [0, 3, 3.5, 4, 4.5, 1.5, 0.5]}),
    "overwritten_remove": (
        OVERWRITTEN_REMOVE, [3, 3.5, 7.5, 5, 5.5, 0, 6, 6.5, 4, 4.5, 0.5],
        {}),
}


def items_of(client):
    tree = client.tree
    out = []
    for seg in tree.segments:
        if tree.visible_length(seg, tree.current_seq, client.client_id) \
                and hasattr(seg.text, "values"):
            out.extend(seg.text.values)
    return out


def run_script(make, script, n_clients=2, values=lambda k: [k, k + 0.5]):
    """Drive the script (op k inserts values(k)); returns (client item
    lists, replica items, log)."""
    clients = [make(i) for i in range(n_clients)]
    log, cur, made = [], [0] * n_clients, 0

    def deliver(i):
        contents, seq, ref, who = log[cur[i]]
        clients[i].apply_msg(contents, seq, ref, who)
        cur[i] += 1

    for event, i, op in script:
        if event == "deliver":
            deliver(i)
            continue
        client = clients[i]
        if op[0] == INS:
            contents = client.insert_items_local(op[1], values(made))
        else:
            contents = client.remove_range_local(op[1], op[2])
        ref = log[cur[i] - 1][1] if cur[i] else 0
        log.append((contents, len(log) + 1, ref, i))
        made += 1
    for i in range(n_clients):
        while cur[i] < len(log):
            deliver(i)
    replica = make(-9)
    for contents, seq, ref, who in log:
        replica.apply_msg(contents, seq, ref, who)
    return [items_of(c) for c in clients], items_of(replica), log


def port_client(i):
    return MergeTreeClient(i, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_scripted_interleaving_converges(name):
    script, want, jax_faults = CASES[name]
    port_items, port_replica, port_log = run_script(port_client, script)
    jax_items, jax_replica, jax_log = run_script(JaxClient, script)
    # The same ops on the wire, and the same sequenced replica.
    assert port_log == jax_log
    assert port_replica == jax_replica == want
    assert port_items == [want, want]
    # The JAX package keeps the fault: its client ends in another order.
    for i, items in enumerate(jax_items):
        assert items == jax_faults.get(i, want)


def random_script(rng, n_ops, n_clients, p_deliver):
    script, made, sent, seen = [], 0, 0, [0] * n_clients
    while made < n_ops:
        i = rng.randrange(n_clients)
        if seen[i] < sent and rng.random() < p_deliver:
            script.append(("deliver", i, None))
            seen[i] += 1
        else:
            script.append(("local", i, None))
            made += 1
            sent += 1
    return script


def run_random(make, seed, n_ops, n_clients, p_deliver):
    """A seeded session: inserts of two items and short removes on each
    client's current view."""
    rng = random.Random(seed)
    script = random_script(rng, n_ops, n_clients, p_deliver)
    ops = random.Random(seed + 1)

    def pick(client):
        n = client.get_length()
        if ops.random() < 0.7 or n < 3:
            return (INS, ops.randrange(n + 1))
        a = ops.randrange(n - 1)
        return (REM, a, min(n, a + ops.randrange(1, 3)))

    # Ops depend on the live view, so they are chosen while driving.
    clients = [make(i) for i in range(n_clients)]
    log, cur, made = [], [0] * n_clients, 0
    for event, i, _ in script:
        if event == "deliver":
            contents, seq, ref, who = log[cur[i]]
            clients[i].apply_msg(contents, seq, ref, who)
            cur[i] += 1
            continue
        op = pick(clients[i])
        if op[0] == INS:
            contents = clients[i].insert_items_local(op[1],
                                                     [made, made + 0.5])
        else:
            contents = clients[i].remove_range_local(op[1], op[2])
        ref = log[cur[i] - 1][1] if cur[i] else 0
        log.append((contents, len(log) + 1, ref, i))
        made += 1
    for i in range(n_clients):
        while cur[i] < len(log):
            contents, seq, ref, who = log[cur[i]]
            clients[i].apply_msg(contents, seq, ref, who)
            cur[i] += 1
    replica = make(-9)
    for contents, seq, ref, who in log:
        replica.apply_msg(contents, seq, ref, who)
    return [items_of(c) for c in clients], items_of(replica), log


@pytest.mark.parametrize("n_clients", [2, 3])
def test_seeded_sessions_converge(n_clients):
    diverged_jax = 0
    for seed in range(40):
        p = (0.2, 0.5, 0.8)[seed % 3]
        items, replica, log = run_random(port_client, seed, 24, n_clients,
                                         p)
        assert items == [replica] * n_clients, seed
        # The replica's semantics are the JAX package's, op for op.
        jax_replica = JaxClient(-9)
        for contents, seq, ref, who in log:
            jax_replica.apply_msg(contents, seq, ref, who)
        assert items_of(jax_replica) == replica, seed
        jax_items, _, jax_log = run_random(JaxClient, seed, 24, n_clients,
                                           p)
        diverged_jax += jax_log == log and jax_items != [replica] * n_clients
    # The seeds reach the fault: the JAX package's clients diverge on some.
    assert diverged_jax > 0


def test_bulk_catch_up_moves_pending_inserts():
    """The bulk path places the tail by the kernels' rule, then moves the
    pending inserts as the scalar path does. The kernels' op packer takes
    integer items."""

    def values(k):
        return [10 * k, 10 * k + 5]

    _, want, log = run_script(port_client, TOMBSTONE_SKIP, values=values)

    def client_one():
        # Client 1 up to its last local insert, before seq 4 arrives.
        c = port_client(1)
        c.apply_msg(*log[0])
        c.insert_items_local(1, values(1))
        c.apply_msg(*log[1])
        c.remove_range_local(1, 2)
        c.apply_msg(*log[2])
        c.insert_items_local(1, values(4))
        return c

    scalar, bulk = client_one(), client_one()
    tail = [(contents, seq, ref, who, 0)
            for contents, seq, ref, who in log[3:4]]
    scalar.apply_msg(*log[3])
    bulk.apply_bulk(tail, "cpu")
    assert items_of(bulk) == items_of(scalar) == want
    assert [(s.ins_seq, s.rem_seq) for s in bulk.tree.segments] == \
        [(s.ins_seq, s.rem_seq) for s in scalar.tree.segments]
    scalar.apply_msg(*log[4])
    bulk.apply_msg(*log[4])
    assert items_of(bulk) == items_of(scalar) == want
    assert not bulk.tree.pending_groups
