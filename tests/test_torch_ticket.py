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
from fluidframework_tpu_torch.testing.traces import \
    raw_ticket_trace as raw_trace

from test_torch_fused_apply import jax_to_np


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


class TestKernelRouting:
    """Which version each caller reaches: CPU tensors the plain loop, the
    plain compositions scan_tickets_plain on any device, and the kernel
    wrapper's checks before anything launches."""

    def test_cpu_tensors_take_the_plain_version(self):
        raw = raw_trace(40, 5, 20, n_clients=6, with_kind=True)
        state = tk.make_ticket_state(4, 5, device="cpu")
        ops = interop.raw_ops_from_numpy(raw, "cpu")
        tk.scan_tickets.launches = 0
        got = tk.scan_tickets(state, ops, require_join=True)
        want = tk.scan_tickets_plain(state, ops, require_join=True)
        assert_dicts_equal(interop.to_numpy(got[0]),
                           interop.to_numpy(want[0]))
        assert_dicts_equal(interop.to_numpy(got[1]),
                           interop.to_numpy(want[1]))
        assert tk.scan_tickets.launches == 0

    def test_plain_full_step_composes_scan_tickets_plain(self, monkeypatch):
        from fluidframework_tpu_torch.mergetree.state import make_state
        from fluidframework_tpu_torch.server import pipeline
        from fluidframework_tpu_torch.testing.traces import gen_traces
        calls = []
        plain = tk.scan_tickets_plain

        def refuse(*_args, **_kwargs):
            raise AssertionError("the plain step reached scan_tickets")

        def counted(*args, **kwargs):
            calls.append(1)
            return plain(*args, **kwargs)

        monkeypatch.setattr(tk, "scan_tickets", refuse)
        monkeypatch.setattr(tk, "scan_tickets_plain", counted)
        ops = interop.packed_ops_from_numpy(gen_traces(4, 12, seed=1), "cpu")
        raw = tk.RawOps(client=ops.client, client_seq=ops.seq,
                        ref_seq=ops.ref_seq)
        out = pipeline.make_full_step(plain=True)(
            tk.make_ticket_state(8, 4, device="cpu"),
            make_state(64, 1, batch=4, device="cpu"), raw, ops)
        assert calls == [1]
        assert bool((out[2].seq > 0).any())
        monkeypatch.setattr(tk, "scan_tickets", counted)
        monkeypatch.setattr(tk, "scan_tickets_plain", refuse)
        pipeline.make_full_step()(
            tk.make_ticket_state(8, 4, device="cpu"),
            make_state(64, 1, batch=4, device="cpu"), raw, ops)
        assert calls == [1, 1]

    def test_plain_ring_composes_scan_tickets_plain(self, monkeypatch):
        from fluidframework_tpu_torch.mergetree.paging import PagedMergeStore
        from fluidframework_tpu_torch.server import serve_step
        from fluidframework_tpu_torch.server.lww_kernel import \
            make_lww_state
        from fluidframework_tpu_torch.testing import serving
        fleet = serving.ServingFleet(serving.SMALL_RING, seed=0)
        store = PagedMergeStore(page_rows=16, pages=8, anno_slots=4,
                                overlap_slots=3, device="cpu")
        ring = fleet.stage_ring(store)
        args = interop.ring_args_from_numpy(ring.args, "cpu")
        ts = tk.make_ticket_state(serving.TICKET_CLIENTS, fleet.spec.docs,
                                  device="cpu")
        lww = [make_lww_state(fleet.spec.lww_capacity, fleet.lww_lanes,
                              device="cpu")]
        calls = {"plain": 0, "wrapper": 0}
        plain, wrapper = tk.scan_tickets_plain, tk.scan_tickets

        def counted(name, fn):
            def call(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return call

        monkeypatch.setattr(tk, "scan_tickets_plain",
                            counted("plain", plain))
        monkeypatch.setattr(tk, "scan_tickets", counted("wrapper", wrapper))
        want = serve_step.make_serve_megakernel(keep=True, plain=True)(
            ts, store.pool, lww, *args)
        assert calls == {"plain": fleet.spec.windows, "wrapper": 0}
        got = serve_step.serve_megakernel_keep(ts, store.pool, lww, *args)
        # the wrapper takes the plain version for these CPU tensors
        assert calls == {"plain": 2 * fleet.spec.windows,
                         "wrapper": fleet.spec.windows}
        assert_dicts_equal(interop.to_numpy(got[0]),
                           interop.to_numpy(want[0]))
        np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())

    @pytest.mark.parametrize("fault", ["strided", "int64", "bool_seq",
                                       "shape", "slots", "device"])
    def test_launch_checks_raise_before_any_launch(self, monkeypatch, fault):
        """Tensors bound for the kernel (here on the meta device, which
        is not the CPU) are checked for type, shape and contiguity, then
        for the CUDA device, before the library is built or anything
        launches."""
        from fluidframework_tpu_torch.kernels import build

        def no_library():
            raise AssertionError("the library was reached")

        monkeypatch.setattr(build, "library", no_library)
        b, t, k = 4, 6, tk.MAX_KERNEL_SLOTS + 1 if fault == "slots" else 8
        state = tk.make_ticket_state(k, b, device="meta")
        cols = {f: torch.empty((b, t), dtype=torch.int32, device="meta")
                for f in ("client", "client_seq", "ref_seq")}
        if fault == "strided":
            cols["client"] = torch.empty((t, b), dtype=torch.int32,
                                         device="meta").t()
        elif fault == "int64":
            cols["ref_seq"] = cols["ref_seq"].long()
        elif fault == "bool_seq":
            state = state._replace(next_seq=state.next_seq.bool())
        elif fault == "shape":
            cols["client_seq"] = cols["client_seq"][:, :-1]
        match = {"strided": "not contiguous", "int64": "torch.int64",
                 "bool_seq": "torch.bool", "shape": "shape",
                 "slots": "client slots", "device": "CUDA"}[fault]
        tk.scan_tickets.launches = 0
        with pytest.raises(ValueError, match=match):
            tk.scan_tickets(state, tk.RawOps(**cols))
        assert tk.scan_tickets.launches == 0


class TestTicketScanOps:
    """chip_smoke.ticket_scan_ops, the operation count behind the ticket
    scan's bound, on windows small enough to count by hand: per message,
    30 scalar operations; per slot, 2 for a LEAVE, 2 for an OP's or a
    JOIN's votes, 1 for a ticketed OP's or JOIN's update, 3 for a
    ticketed message's MSN and 1 where the table changed."""

    CASES = {
        # JOIN c0, OP c0, OP c1 (not joined), LEAVE c0, SYSTEM, padding:
        # leave 2, votes 2 x 3, MSN 3 x 4, update 1 x 2, changed 1 x 3.
        "kind_require_join": (
            4, True, [[2, 1, 1, 3, 4, 0]], [[0, 0, 1, 0, -1, -1]],
            [[0, 1, 1, 0, 0, 0]], (2 + 6 + 12 + 2 + 3) * 4 + 6 * 30),
        # two distinct joiners into a one-slot table: both take a seq, the
        # second finds it full and the document overflows, so neither join
        # counts its update or the emptiness test: votes 2 x 2, MSN 3 x 2.
        "full_table": (
            1, True, [[2, 2]], [[0, 1]], [[0, 0]], (4 + 6) * 1 + 2 * 30),
        # no kind column: three OPs of one client, the last a duplicate:
        # votes 2 x 3, MSN 3 x 2, update 1 x 2, changed 1 x 2.
        "no_kind": (
            8, False, None, [[5, 5, 5]], [[1, 2, 2]],
            (6 + 6 + 2 + 2) * 8 + 3 * 30),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_counts_this_windows_work(self, case):
        import chip_smoke

        k, require_join, kind, client, cseq, want = self.CASES[case]
        client = torch.tensor(client, dtype=torch.int32)
        raw = tk.RawOps(
            client=client, client_seq=torch.tensor(cseq, dtype=torch.int32),
            ref_seq=torch.zeros_like(client),
            kind=None if kind is None else torch.tensor(kind,
                                                        dtype=torch.int32))
        state, out = tk.scan_tickets_plain(
            tk.make_ticket_state(k, client.shape[0], device="cpu"), raw,
            require_join=require_join)
        assert chip_smoke.ticket_scan_ops(raw, out, state.overflow, k) \
            == want
