"""The port's deli ticketing (fluidframework_tpu_torch/server/ticket_kernel.py)
against the JAX package's _scan_tickets, bit for bit, on seeded numpy
traces: with and without a MsgKind column (OP/JOIN/LEAVE/SYSTEM,
duplicate clientSeqs, stale refSeqs, more clients than table slots) at
K=4 (the entry() shape) and K=8 (the bench shape)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.server import ticket_kernel as jtk

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.server import ticket_kernel as tk

from test_torch_fused_apply import jax_to_np


def raw_trace(seed: int, b: int, t: int, n_clients: int, with_kind: bool):
    """Messages from up to n_clients clients per doc: increasing
    clientSeqs with ~15% repeats (duplicates), refSeqs that lag or run
    stale, NOOP gaps, and (with_kind) JOIN/LEAVE/SYSTEM messages."""
    rng = np.random.default_rng(seed)
    client = rng.integers(-1, n_clients, (b, t)).astype(np.int32)
    step = (rng.random((b, t)) > 0.15).astype(np.int32)
    client_seq = np.cumsum(step, axis=1).astype(np.int32)
    lag = rng.integers(0, 6, (b, t))
    ref_seq = np.maximum(np.arange(t)[None, :] - lag, 0).astype(np.int32)
    out = {"client": client, "client_seq": client_seq, "ref_seq": ref_seq}
    if with_kind:
        kind = rng.choice(np.array([0, 1, 2, 3, 4], np.int32), (b, t),
                          p=[0.05, 0.6, 0.2, 0.1, 0.05])
        out["kind"] = kind.astype(np.int32)
    return out


def jax_raw(raw: dict) -> jtk.RawOps:
    return jtk.RawOps(client=jnp.asarray(raw["client"]),
                      client_seq=jnp.asarray(raw["client_seq"]),
                      ref_seq=jnp.asarray(raw["ref_seq"]),
                      kind=None if raw.get("kind") is None
                      else jnp.asarray(raw["kind"]))


def run_both(raw: dict, k: int, require_join: bool, seed_state=None):
    b = raw["client"].shape[0]
    jstate = seed_state if seed_state is not None else \
        jtk.make_ticket_state(k, batch=b)
    jst, jout = jtk._scan_tickets(jstate, jax_raw(raw), batched=True,
                                  require_join=require_join)
    pst, pout = tk.scan_tickets(
        interop.ticket_state_from_numpy(jax_to_np(jstate), "cpu"),
        interop.raw_ops_from_numpy(raw, "cpu"), require_join=require_join)
    return (jax_to_np(jst), jax_to_np(jout), interop.to_numpy(pst),
            interop.to_numpy(pout))


def assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


class TestScanTickets:
    @pytest.mark.parametrize("k", [4, 8])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_no_kind_column(self, k, seed):
        raw = raw_trace(seed, 12, 40, n_clients=k + 2, with_kind=False)
        jst, jout, pst, pout = run_both(raw, k, require_join=False)
        assert_dicts_equal(pst, jst)
        assert_dicts_equal(pout, jout)
        assert jout["nacked"].any() and (jout["seq"] > 0).any()

    @pytest.mark.parametrize("k", [4, 8])
    @pytest.mark.parametrize("require_join", [False, True])
    def test_kind_column(self, k, require_join):
        raw = raw_trace(10 + k, 12, 48, n_clients=k + 3, with_kind=True)
        jst, jout, pst, pout = run_both(raw, k, require_join=require_join)
        assert_dicts_equal(pst, jst)
        assert_dicts_equal(pout, jout)
        if require_join:
            assert jout["not_joined"].any()

    def test_full_client_table_overflows(self):
        # 6 distinct joiners into a 4-slot table, no leaves.
        b, t = 3, 12
        raw = {"client": np.tile(np.arange(12, dtype=np.int32) % 6, (b, 1)),
               "client_seq": np.tile(np.arange(1, t + 1, dtype=np.int32),
                                     (b, 1)),
               "ref_seq": np.zeros((b, t), np.int32),
               "kind": np.full((b, t), 2, np.int32)}
        jst, jout, pst, pout = run_both(raw, 4, require_join=True)
        assert_dicts_equal(pst, jst)
        assert_dicts_equal(pout, jout)
        assert jst["overflow"].all()

    def test_batched_entry_points(self):
        raw = raw_trace(7, 6, 20, n_clients=5, with_kind=True)
        jstate = jtk.make_ticket_state(4, batch=6)
        p_in = jax_to_np(jstate)
        jst, jout = jtk.sequence_batched_strict(jstate, jax_raw(raw))
        pst, pout = tk.sequence_batched_strict(
            interop.ticket_state_from_numpy(p_in, "cpu"),
            interop.raw_ops_from_numpy(raw, "cpu"))
        assert_dicts_equal(interop.to_numpy(pst), jax_to_np(jst))
        assert_dicts_equal(interop.to_numpy(pout), jax_to_np(jout))

        raw.pop("kind")
        jstate = jtk.make_ticket_state(8, batch=6)
        p_in = jax_to_np(jstate)
        jst, jout = jtk.ticket_ops_batched(jstate, jax_raw(raw))
        pst, pout = tk.ticket_ops_batched(
            interop.ticket_state_from_numpy(p_in, "cpu"),
            interop.raw_ops_from_numpy(raw, "cpu"))
        assert_dicts_equal(interop.to_numpy(pst), jax_to_np(jst))
        assert_dicts_equal(interop.to_numpy(pout), jax_to_np(jout))

    def test_second_window_continues_state(self):
        """Ticketing two windows back to back carries the table across."""
        raw1 = raw_trace(20, 8, 16, n_clients=6, with_kind=True)
        raw2 = raw_trace(21, 8, 16, n_clients=6, with_kind=True)
        jst, _, _, _ = run_both(raw1, 8, require_join=False)
        jseed = jtk.TicketState(**{f: jnp.asarray(v) for f, v in jst.items()})
        jst2, jout2, pst2, pout2 = run_both(raw2, 8, require_join=False,
                                            seed_state=jseed)
        assert_dicts_equal(pst2, jst2)
        assert_dicts_equal(pout2, jout2)


class TestEvict:
    @pytest.mark.parametrize("k", [4, 8])
    def test_evict_matches(self, k):
        raw = raw_trace(30 + k, 10, 30, n_clients=k, with_kind=True)
        jst, _, _, _ = run_both(raw, k, require_join=False)
        clients = np.random.default_rng(k).integers(
            -1, k, 10).astype(np.int32)
        want = jax_to_np(jtk.evict_clients_batched(
            jtk.TicketState(**{f: jnp.asarray(v) for f, v in jst.items()}),
            jnp.asarray(clients)))
        got = tk.evict_clients_batched(
            interop.ticket_state_from_numpy(jst, "cpu"),
            torch.from_numpy(clients))
        assert_dicts_equal(interop.to_numpy(got), want)
