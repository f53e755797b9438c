"""The golden files for the card (fluidframework_tpu_torch/testing/golden/
fused_apply_golden.npz, serve_megakernel_golden.npz, catchup_golden.json,
extract_golden.npz / .json and lane_store_golden.npz / .json): regenerated here from the JAX package and
required equal to the committed files, then replayed through the port on
the CPU.

To rewrite the files after a deliberate change of their inputs (the
100,000-op catch-up digest takes about 70 s of JAX on the CPU):
    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""

import json
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from fluidframework_tpu.mergetree import catchup as jcatchup  # noqa: E402
from fluidframework_tpu.mergetree import host as jhost  # noqa: E402
from fluidframework_tpu.mergetree import kernel as jkernel  # noqa: E402
from fluidframework_tpu.mergetree import pallas_apply  # noqa: E402
from fluidframework_tpu.mergetree.host import OpBuilder  # noqa: E402
from fluidframework_tpu.mergetree.oppack import (  # noqa: E402
    HostOp, OpKind, PackedOps as JaxPackedOps, pack_ops as jax_pack_ops)
from fluidframework_tpu.mergetree.state import (  # noqa: E402
    make_state as jax_make_state)
from fluidframework_tpu.server import ticket_kernel as jtk  # noqa: E402
from fluidframework_tpu.server import tpu_sequencer as jseq  # noqa: E402
from fluidframework_tpu.server.pipeline import make_full_step  # noqa: E402
from fluidframework_tpu.telemetry import counters as jcounters  # noqa: E402
from fluidframework_tpu.testing.traces import (  # noqa: E402
    keystroke_trace as jax_keystroke_trace)

from fluidframework_tpu_torch import interop  # noqa: E402
from fluidframework_tpu_torch.mergetree import catchup  # noqa: E402
from fluidframework_tpu_torch.mergetree import host as thost  # noqa: E402
from fluidframework_tpu_torch.mergetree import kernel as tkernel  # noqa: E402
from fluidframework_tpu_torch.mergetree.oppack import (  # noqa: E402
    pack_ops as port_pack_ops)
from fluidframework_tpu_torch.mergetree.state import (  # noqa: E402
    make_state as port_make_state)
from fluidframework_tpu_torch.telemetry import (  # noqa: E402
    counters as tcounters)
from fluidframework_tpu_torch.mergetree.pallas_apply import (  # noqa: E402
    apply_ops_fused)
from fluidframework_tpu_torch.server import pipeline  # noqa: E402
from fluidframework_tpu_torch.testing import golden  # noqa: E402
from fluidframework_tpu_torch.testing import lanes  # noqa: E402
from fluidframework_tpu_torch.server import (  # noqa: E402
    tpu_sequencer as tseq)
from fluidframework_tpu_torch.server import serve_step  # noqa: E402
from fluidframework_tpu_torch.testing import serving  # noqa: E402
from fluidframework_tpu_torch.testing.traces import (  # noqa: E402
    gen_traces, keystroke_trace)

from test_kernel import build_kernel_ops, random_schedule  # noqa: E402
from test_torch_fused_apply import (  # noqa: E402
    client_mode_streams, jax_to_np)
from test_torch_serving import (  # noqa: E402
    Fleet, jax_megakernel, port_megakernel)

APPLY_CAPACITY, APPLY_ANNO, APPLY_STEPS = 100, 2, 60
STEP_DOCS, STEP_OPS, STEP_CAPACITY, STEP_CLIENTS = 16, 32, 64, 4
SERVE_SEED = 0   # SMALL_RING fleet; the golden ring is its second ring


def _capacity_overflow_doc():
    """Every insert splits the previous one: +2 slots per op until the
    count + 2 <= C gate trips."""
    ops = [HostOp(OpKind.INSERT, 1, 0, 1, pos1=0, op_id=0, new_len=2)]
    for i in range(1, APPLY_STEPS):
        ops.append(HostOp(OpKind.INSERT, i + 1, i, 1, pos1=i, op_id=i,
                          new_len=2, msn=i))
    return ops


def _overlap_overflow_doc():
    """Four clients remove the same range concurrently: K=3 slots hold
    three of them, the fourth flags overflow."""
    ops = [HostOp(OpKind.INSERT, 1, 0, 1, pos1=0, op_id=0, new_len=6)]
    for c in range(2, 6):
        ops.append(HostOp(OpKind.REMOVE, c, 1, c, pos1=1, pos2=5, msn=1))
    return ops


def apply_inputs():
    streams = [
        build_kernel_ops(OpBuilder(), random_schedule(random.Random(600),
                                                      4, 40)),
        build_kernel_ops(OpBuilder(), random_schedule(random.Random(601),
                                                      3, 60)),
        client_mode_streams(random.Random(602), APPLY_STEPS),
        client_mode_streams(random.Random(603), APPLY_STEPS),
        _capacity_overflow_doc(),
        _overlap_overflow_doc(),
    ]
    state = jax_make_state(APPLY_CAPACITY, APPLY_ANNO, batch=len(streams))
    return state, jax_pack_ops(streams, steps=APPLY_STEPS)


def step_inputs():
    cols = gen_traces(STEP_DOCS, STEP_OPS, seed=5)
    client_seq = cols["seq"].copy()
    client_seq[::2, 10] = client_seq[::2, 9]   # duplicates: dropped
    client_seq[1::4, 20] = 0                    # replays of old clientSeqs
    raw = {"client": cols["client"], "client_seq": client_seq,
           "ref_seq": cols["ref_seq"]}
    tstate = jtk.make_ticket_state(STEP_CLIENTS, batch=STEP_DOCS)
    mstate = jax_make_state(STEP_CAPACITY, 1, batch=STEP_DOCS)
    return tstate, mstate, raw, cols


def build_golden():
    state, ops = apply_inputs()
    out = pallas_apply.apply_ops_fused_ref(state, ops)
    tstate, mstate, raw, cols = step_inputs()
    sections = {"apply_in": jax_to_np(state), "apply_op": jax_to_np(ops),
                "apply_out": jax_to_np(out),
                "step_tin": jax_to_np(tstate), "step_min": jax_to_np(mstate),
                "step_raw": raw, "step_op": cols}
    step = jax.jit(make_full_step(fused_apply=False))
    j_raw = jtk.RawOps(**{f: jnp.asarray(v) for f, v in raw.items()})
    j_ops = JaxPackedOps(**{f: jnp.asarray(cols[f])
                            for f in JaxPackedOps._fields})
    tout, mout, ticketed, total = step(tstate, mstate, j_raw, j_ops)
    sections.update(step_tout=jax_to_np(tout), step_mout=jax_to_np(mout),
                    step_ticketed=jax_to_np(ticketed),
                    step_total={"total_len": np.asarray(total)})
    return sections


def _np_dict(tup):
    return {f: np.asarray(v) for f, v in zip(tup._fields, tup)}


def build_serve_golden():
    """The second ring of a SMALL_RING fleet (the first grows the
    documents from empty through JAX), with the JAX package's
    serve_megakernel_keep outputs, stats on."""
    f = Fleet(SERVE_SEED)
    first = f.stage()
    f.advance(first, jax_megakernel(f.tstate, f.pool, f.lww, first.args))
    ring = f.stage()
    ts, pool, lww, flat16_k, msn_k, pre = jax_megakernel(
        f.tstate, f.pool, f.lww, ring.args, stats=True)
    sections = {"tstate_in": _np_dict(f.tstate), "pool_in": _np_dict(f.pool),
                "ring": serving.ring_to_arrays(ring.args),
                "tstate_out": _np_dict(ts), "pool_out": _np_dict(pool),
                "wire": {"flat16_k": flat16_k, "msn_k": msn_k},
                "expect": {"overflow": np.concatenate(
                    ring.expected_overflow)}}
    for i, (s_in, s_out) in enumerate(zip(f.lww, lww)):
        sections[f"lww_in_{i}"] = _np_dict(s_in)
        sections[f"lww_out_{i}"] = _np_dict(s_out)
    for g, view in enumerate(pre):
        sections[f"pre_{g}"] = _np_dict(view)
    return sections


def _jax_catchup(trace):
    n_ops, seed, n_clients = trace
    tail = jax_keystroke_trace(n_ops, seed=seed, n_clients=n_clients)
    return jcatchup.device_apply_tail([], tail, 0, 0)


def build_catchup_small():
    """The JAX package's catch-up entries of the small keystroke trace."""
    return {"trace": list(golden.CATCHUP_SMALL),
            "entries": _jax_catchup(golden.CATCHUP_SMALL)}


def build_catchup_full():
    """The digest of the JAX package's catch-up of the 100,000-op trace."""
    return {"trace": list(golden.CATCHUP_FULL),
            "digest": golden.entries_digest(
                _jax_catchup(golden.CATCHUP_FULL))}


WIRE_COUNTERS = ("summarize.bytes_d2h", "summarize.wire_refetch")


def fetch_counted(kernel_mod, counters_mod, packed, narrow):
    """kernel.fetch_extracted and its counter deltas, as golden arrays."""
    before = [counters_mod.get(c) for c in WIRE_COUNTERS]
    out = kernel_mod.fetch_extracted(packed, narrow=narrow)
    d_bytes, d_refetch = (counters_mod.get(c) - b
                          for c, b in zip(WIRE_COUNTERS, before))
    return out, np.asarray(int(d_bytes), np.int64), \
        np.asarray(int(d_refetch), np.int64)


def extract_sections(kernel_mod, counters_mod, state, state_in):
    """The extraction golden's .npz sections from one package's kernel
    module on `state` (state_in: its numpy dict)."""
    comp, packed, pre = kernel_mod.compact_extract_batched(state, stats=True)
    narrow, n_bytes, refetch = fetch_counted(kernel_mod, counters_mod,
                                             packed, True)
    wide, w_bytes, _ = fetch_counted(kernel_mod, counters_mod, packed,
                                     False)

    def host(x):
        return np.array(x.cpu() if hasattr(x, "cpu") else x)

    sections = {
        "state_in": state_in,
        "compacted": {f: host(v) for f, v in zip(comp._fields, comp)},
        "packed": {f: host(v) for f, v in zip(golden.PACKED_FIELDS,
                                              packed)},
        "pre_counts": {"count": host(pre)},
        "narrow": dict(zip(golden.PACKED_FIELDS, narrow)),
        "wide": dict(zip(golden.PACKED_FIELDS, wide)),
        "wire": {"narrow_bytes": n_bytes, "wide_bytes": w_bytes,
                 "refetch": refetch}}
    return sections, narrow


def extract_doc(assemble, narrow, payloads, state_in, blob):
    """The extraction golden's .json content (payloads left as given)."""
    snaps = {str(d): assemble(narrow, payloads, d,
                              min_seq=int(state_in["min_seq"][d]),
                              seq=int(state_in["seq"][d]))
             for d in golden.EXTRACT_DOCS}
    return {"payloads": payloads, "snapshots": snaps,
            "catchup_base": golden.CATCHUP_BLOB_BASE, "catchup_blob": blob}


def _small_catchup_entries():
    with open(golden.CATCHUP_GOLDEN_PATH) as f:
        return json.load(f)["small"]["entries"]   # wire-encoded


def build_extract_golden():
    """The JAX package's summarize path on golden.extract_streams' batch:
    (.npz sections, .json document)."""
    builder = OpBuilder()
    streams = golden.extract_streams(builder)
    state = jkernel.apply_ops_batched_keep(
        jax_make_state(golden.EXTRACT_CAPACITY, golden.EXTRACT_ANNO,
                       batch=len(streams)),
        jax_pack_ops(streams, steps=golden.EXTRACT_OPS))
    sections, narrow = extract_sections(jkernel, jcounters, state,
                                        jax_to_np(state))
    doc = extract_doc(jhost.assemble_snapshot, narrow, builder.payloads,
                      sections["state_in"],
                      jcatchup.pack_entries_narrow(
                          _small_catchup_entries(),
                          golden.CATCHUP_BLOB_BASE))
    doc["payloads"] = golden.encode_payloads(builder.payloads)
    return sections, doc


def build_lane_store_golden():
    """The JAX package's lane stores on the golden scenario."""
    return lanes.golden_run(jseq, jcounters)


def _json_round_trip(doc):
    return json.loads(json.dumps(doc, sort_keys=True))


def _assert_sections_equal(got, want):
    assert sorted(got) == sorted(want)
    for section in want:
        assert sorted(got[section]) == sorted(want[section]), section
        for field, arr in want[section].items():
            g = np.asarray(got[section][field])
            assert g.dtype == arr.dtype, f"{section}.{field}"
            np.testing.assert_array_equal(g, arr,
                                          err_msg=f"{section}.{field}")


class TestGolden:
    def test_committed_file_matches_jax(self):
        _assert_sections_equal(golden.load(), build_golden())

    def test_committed_serve_file_matches_jax(self):
        _assert_sections_equal(golden.load(golden.SERVE_GOLDEN_PATH),
                               build_serve_golden())

    def test_serve_golden_covers_the_hard_cases(self):
        g = golden.load(golden.SERVE_GOLDEN_PATH)
        ring = serving.ring_from_arrays(g["ring"])
        assert len(ring.page_ids) >= 2                       # page groups
        assert any(r is not None for r in ring.runs_xs)      # INSERT_RUN
        assert g["expect"]["overflow"].any()                 # mispredicted
        assert ring.lww_xs and (ring.lww_xs[0][:, 0] > 0).any()
        b, t = ring.ticket_xs.shape[2:]
        flags = g["wire"]["flat16_k"][:, 2 * b * t:3 * b * t]
        assert (flags & 1).any()                             # nacks

    def test_port_megakernel_matches_serve_golden(self):
        from fluidframework_tpu_torch.mergetree.state import DocState
        from fluidframework_tpu_torch.server.lww_kernel import LwwState
        from fluidframework_tpu_torch.server.ticket_kernel import (
            TicketState)
        g = golden.load(golden.SERVE_GOLDEN_PATH)
        n_lww = sum(1 for k in g if k.startswith("lww_in_"))
        got = port_megakernel(
            TicketState(**g["tstate_in"]), DocState(**g["pool_in"]),
            [LwwState(**g[f"lww_in_{i}"]) for i in range(n_lww)],
            serving.ring_from_arrays(g["ring"]), stats=True)
        ts, pool, lww, flat16_k, msn_k, pre = got
        out = {"tstate_out": _np_dict(ts), "pool_out": _np_dict(pool),
               "wire": {"flat16_k": flat16_k, "msn_k": msn_k}}
        out.update({f"lww_out_{i}": _np_dict(s) for i, s in enumerate(lww)})
        out.update({f"pre_{i}": _np_dict(v) for i, v in enumerate(pre)})
        _assert_sections_equal(out, {k: g[k] for k in out})
        assert serve_step.flat16_layout(
            *ring_shape(g), paged_scalars=True,
            stats=True)["total"][1] == flat16_k.shape[1]

    def test_golden_covers_the_hard_cases(self):
        g = golden.load()
        ops, out = g["apply_op"], g["apply_out"]
        assert (ops["kind"] == OpKind.ANNOTATE).any()
        assert (ops["kind"] == OpKind.ACK_INSERT).any()
        assert (ops["kind"] == OpKind.ACK_REMOVE).any()
        assert (ops["seq"] == 2**31 - 1).any()          # pending local ops
        assert out["overflow"][4] and out["overflow"][5]
        assert (out["rem_clients"][..., 1] >= 0).any()   # overlap removers
        assert (g["step_ticketed"]["seq"] == 0).any()    # dropped ops

    def test_port_apply_matches_golden(self):
        g = golden.load()
        got = apply_ops_fused(
            interop.doc_state_from_numpy(g["apply_in"], "cpu"),
            interop.packed_ops_from_numpy(g["apply_op"], "cpu"))
        _assert_sections_equal({"apply_out": interop.to_numpy(got)},
                               {"apply_out": g["apply_out"]})

    def test_port_full_step_matches_golden(self):
        g = golden.load()
        tout, mout, ticketed, total = pipeline.full_step(
            interop.ticket_state_from_numpy(g["step_tin"], "cpu"),
            interop.doc_state_from_numpy(g["step_min"], "cpu"),
            interop.raw_ops_from_numpy(g["step_raw"], "cpu"),
            interop.packed_ops_from_numpy(g["step_op"], "cpu"))
        _assert_sections_equal(
            {"step_tout": interop.to_numpy(tout),
             "step_mout": interop.to_numpy(mout),
             "step_ticketed": interop.to_numpy(ticketed),
             "step_total": {"total_len": total.numpy()}},
            {k: g[k] for k in ("step_tout", "step_mout", "step_ticketed",
                               "step_total")})


class TestCatchupGolden:
    def test_committed_small_entries_match_jax(self):
        assert golden.load_catchup()["small"] == build_catchup_small()

    @pytest.mark.slow  # about 70 s of JAX on the CPU: the 100k-op catch-up
    def test_committed_full_digest_matches_jax(self):
        assert golden.load_catchup()["full"] == build_catchup_full()

    def test_port_catchup_matches_small_golden(self):
        """The port on the CPU (its plain scan) gives the committed
        entries, through the overflow retry: a chunk whose annotate
        rings or rows fill is folded, reseeded and applied again."""
        g = golden.load_catchup()
        n_ops, seed, n_clients = g["small"]["trace"]
        stats = {}
        got = catchup.device_apply_tail(
            [], keystroke_trace(n_ops, seed=seed, n_clients=n_clients), 0,
            0, device="cpu", stats=stats)
        assert got == g["small"]["entries"]
        assert stats["retries"] >= 1
        assert golden.entries_digest(got)["count"] == len(got)

    def test_trace_text_matches_full_digest(self):
        """golden.trace_text, the string replay chip_smoke.py phase 21 (a)
        holds a prefix of the trace to, gives the committed JAX digest's
        text for the whole trace."""
        import hashlib
        g = golden.load_catchup()["full"]
        n_ops, seed, n_clients = g["trace"]
        assert n_clients == 1
        text = golden.trace_text(keystroke_trace(n_ops, seed=seed))
        assert len(text) == g["digest"]["visible_length"]
        assert hashlib.sha256(text.encode()).hexdigest() == \
            g["digest"]["text_sha256"]

    def test_catchup_golden_covers_the_hard_cases(self):
        g = golden.load_catchup()
        small = g["small"]["entries"]
        assert any(e.get("props") for e in small)        # format sweeps
        assert any("seq" in e for e in small)            # collab window
        assert any("removedSeq" in e for e in small)     # contended removes
        assert g["full"]["trace"] == list(golden.CATCHUP_FULL)
        assert g["full"]["digest"]["count"] > len(small)


class TestExtractGolden:
    def test_committed_files_match_jax(self):
        sections, doc = build_extract_golden()
        g = golden.load(golden.EXTRACT_GOLDEN_PATH)
        _assert_sections_equal(g, sections)
        with open(golden.EXTRACT_JSON_PATH) as f:
            assert json.load(f) == _json_round_trip(doc)

    def test_extract_golden_covers_the_hard_cases(self):
        g = golden.load_extract()
        assert int(g["wire"]["refetch"]) == 1            # overflow doc
        assert g["narrow"]["counts"][4] == 0              # empty doc
        assert (g["pre_counts"]["count"]
                > g["compacted"]["count"]).any()          # zamboni
        # with the refetched document's planes the drop is below 40%
        assert g["wire"]["narrow_bytes"] < g["wire"]["wide_bytes"]
        live = np.arange(g["narrow"]["ins_seq"].shape[1])[None, :] < \
            g["narrow"]["counts"][:, None]
        assert (live & (g["narrow"]["ins_seq"] == 2**31 - 1)).any()
        assert (live[..., None] & (g["narrow"]["anno"] >= 0)).any()
        assert sorted(g["json"]["snapshots"]) == list(golden.EXTRACT_DOCS)

    def test_port_matches_extract_golden(self):
        """The port on the CPU: the same op calls through its own builder
        and plain scan give state_in; its extraction, fetches, counters,
        assembly and catch-up blob give the committed outputs."""
        g = golden.load_extract()
        builder = thost.OpBuilder()
        streams = golden.extract_streams(builder)
        state = tkernel.apply_ops_batched_keep(
            port_make_state(golden.EXTRACT_CAPACITY, golden.EXTRACT_ANNO,
                            batch=len(streams), device="cpu"),
            interop.packed_ops_from_numpy(
                port_pack_ops(streams, steps=golden.EXTRACT_OPS), "cpu"))
        _assert_sections_equal({"state_in": interop.to_numpy(state)},
                               {"state_in": g["state_in"]})
        sections, narrow = extract_sections(
            tkernel, tcounters,
            interop.doc_state_from_numpy(g["state_in"], "cpu"),
            g["state_in"])
        _assert_sections_equal(sections, {k: g[k] for k in sections})
        blob = catchup.pack_entries_narrow(_small_catchup_entries(),
                                           golden.CATCHUP_BLOB_BASE)
        doc = extract_doc(thost.assemble_snapshot, narrow,
                          g["json"]["payloads"], g["state_in"], blob)
        assert {int(k): v for k, v in _json_round_trip(
            doc["snapshots"]).items()} == g["json"]["snapshots"]
        assert _json_round_trip(blob) == g["json"]["catchup_blob"]
        assert golden.encode_payloads(builder.payloads) == \
            _json_round_trip(golden.encode_payloads(g["json"]["payloads"]))


class TestLaneStoreGolden:
    def test_committed_files_match_jax(self):
        sections, doc = build_lane_store_golden()
        g = golden.load(golden.LANES_GOLDEN_PATH)
        _assert_sections_equal(g, sections)
        with open(golden.LANES_JSON_PATH) as f:
            assert json.load(f) == _json_round_trip(doc)

    def test_lane_store_golden_covers_the_hard_cases(self):
        doc = golden.load_lanes()["json"]
        b, p = doc["bucketed"], doc["paged"]
        bm, pm = b["merge"], p["merge"]
        assert bm["counts"]["folds"] > 0            # a fold at C >= 256
        assert max(w[0] for w in bm["where"].values()) == 2   # C = 1,024
        assert pm["counts"]["paged_rescues"] > 0    # the annotate storm
        assert pm["counts"]["page_compactions"] > 0
        assert b["blob_cache_hits"] > 0 and p["blob_cache_hits"] > 0
        assert all(b["seeded"].values()) and all(p["seeded"].values())
        assert b["extracts"][1] != b["extracts"][0]
        assert max(w[0] for w in b["lww"]["where"].values()) == 1
        assert sorted(bm["text"]) == sorted(pm["text"])
        assert bm["reseeded"] and set(bm["text"]) - set(bm["reseeded"])
        # the paged and the bucketed store agree on every channel
        assert lanes.cross_store_mismatches(
            b, p, (b["extracts"], p["extracts"])) == []

    def test_port_matches_lane_store_golden(self):
        """The port's stores on the CPU: the same scenario through its own
        builders gives the committed states and results."""
        g = golden.load_lanes()
        sections, doc = lanes.golden_run(tseq, tcounters, device="cpu")
        _assert_sections_equal(sections, {k: g[k] for k in sections})
        assert sorted(sections) == sorted(k for k in g if k != "json")
        assert _json_round_trip(doc) == g["json"]


def ring_shape(g):
    """(B, T, merge lanes, LWW lanes) of a golden ring."""
    ring = serving.ring_from_arrays(g["ring"])
    b, t = ring.ticket_xs.shape[2:]
    return (b, t, [p.shape[0] for p in ring.page_ids],
            [x.shape[2] for x in ring.lww_xs])


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_golden.py --write")
    from fluidframework_tpu.core.platform import force_host_platform
    force_host_platform(1)
    golden.save(build_golden())
    golden.save(build_serve_golden(), golden.SERVE_GOLDEN_PATH)
    golden.save_catchup({"small": build_catchup_small(),
                         "full": build_catchup_full()})
    golden.save_extract(*build_extract_golden())
    golden.save_lanes(*build_lane_store_golden())
    for path in (golden.GOLDEN_PATH, golden.SERVE_GOLDEN_PATH,
                 golden.CATCHUP_GOLDEN_PATH, golden.EXTRACT_GOLDEN_PATH,
                 golden.EXTRACT_JSON_PATH, golden.LANES_GOLDEN_PATH,
                 golden.LANES_JSON_PATH):
        print(f"wrote {path} ({path.stat().st_size} bytes)")
