"""The golden files for the card (fluidframework_tpu_torch/testing/golden/
fused_apply_golden.npz and serve_megakernel_golden.npz): regenerated here
from the JAX package and required equal to the committed files, then
replayed through the port on the CPU.

To rewrite both files after a deliberate change of their inputs:
    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""

import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from fluidframework_tpu.mergetree import pallas_apply  # noqa: E402
from fluidframework_tpu.mergetree.host import OpBuilder  # noqa: E402
from fluidframework_tpu.mergetree.oppack import (  # noqa: E402
    HostOp, OpKind, PackedOps as JaxPackedOps, pack_ops as jax_pack_ops)
from fluidframework_tpu.mergetree.state import (  # noqa: E402
    make_state as jax_make_state)
from fluidframework_tpu.server import ticket_kernel as jtk  # noqa: E402
from fluidframework_tpu.server.pipeline import make_full_step  # noqa: E402

from fluidframework_tpu_torch import interop  # noqa: E402
from fluidframework_tpu_torch.mergetree.pallas_apply import (  # noqa: E402
    apply_ops_fused)
from fluidframework_tpu_torch.server import pipeline  # noqa: E402
from fluidframework_tpu_torch.testing import golden  # noqa: E402
from fluidframework_tpu_torch.server import serve_step  # noqa: E402
from fluidframework_tpu_torch.testing import serving  # noqa: E402
from fluidframework_tpu_torch.testing.traces import gen_traces  # noqa: E402

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
    for path in (golden.GOLDEN_PATH, golden.SERVE_GOLDEN_PATH):
        print(f"wrote {path} ({path.stat().st_size} bytes)")
