"""The summarize path's host half and the catch-up narrow wire against the
JAX package on the CPU: mergetree/host.py assemble_entries,
assemble_snapshot, chunk_entries and flatten_snapshot_content over a rich
schedule (annotates, pending rows, removes above min_seq, markers, an
empty document and one whose seqs span more than int16), and
mergetree/catchup.py pack_entries_narrow / unpack_entries_narrow /
translate_entry_clients. Dicts, blobs and their JSON must be equal;
there is no tolerance.

Both packages' OpBuilders get the same calls (testing/golden.
extract_streams, the extraction golden's batch), so their payload tables
assign the same op ids; the packed rows come from the port's extraction on
the CPU (held to JAX's by tests/test_torch_extract.py) and feed both
assemblers.
"""

import copy
import json

import numpy as np
import pytest

from fluidframework_tpu.mergetree import catchup as jcatchup
from fluidframework_tpu.mergetree import host as jhost

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import catchup, host, kernel
from fluidframework_tpu_torch.mergetree.constants import SEG_MARKER, SEG_TEXT
from fluidframework_tpu_torch.mergetree.oppack import pack_ops
from fluidframework_tpu_torch.mergetree.runs import encode_entry_payloads
from fluidframework_tpu_torch.mergetree.state import make_state
from fluidframework_tpu_torch.testing import golden

_BATCH = {}


def summary_batch():
    """(fetched narrow packed rows, min_seqs, seqs, port payloads, JAX
    payloads), cached."""
    if not _BATCH:
        builder, jbuilder = host.OpBuilder(), jhost.OpBuilder()
        streams = golden.extract_streams(builder)
        golden.extract_streams(jbuilder)
        state = kernel.apply_ops_batched_keep(
            make_state(golden.EXTRACT_CAPACITY, golden.EXTRACT_ANNO,
                       batch=len(streams), device="cpu"),
            interop.packed_ops_from_numpy(
                pack_ops(streams, steps=golden.EXTRACT_OPS), "cpu"))
        assert not bool(state.overflow.any())
        _comp, packed, _pre = kernel.compact_extract_batched(state,
                                                             stats=True)
        _BATCH.update(packed=kernel.fetch_extracted(packed),
                      min_seqs=state.min_seq.numpy().copy(),
                      seqs=state.seq.numpy().copy(),
                      payloads=builder.payloads, jpayloads=jbuilder.payloads)
    return _BATCH


def test_batch_covers_the_hard_cases():
    b = summary_batch()
    (op32, _off, _len, anno, ins_seq, _ic, rem_seq, _rc, counts) = \
        b["packed"]
    live = np.arange(op32.shape[1])[None, :] < counts[:, None]
    assert counts[4] == 0                                   # empty doc
    assert ((anno >= 0) & live[..., None]).any()            # annotates
    assert (live & (ins_seq == 2**31 - 1)).any()            # pending
    assert (live & (rem_seq != 2**31 - 2)
            & (rem_seq > b["min_seqs"][:, None])).any()     # collab window
    kinds = [b["payloads"].get(int(i)).kind for i in op32[live]]
    assert SEG_MARKER in kinds and SEG_TEXT in kinds        # markers
    span = ins_seq[5][live[5] & (ins_seq[5] != 2**31 - 1)]
    assert span.max() - span.min() > 32_000                 # refetched


@pytest.mark.parametrize("doc", range(6))
def test_assemble_entries_matches_jax(doc):
    b = summary_batch()
    for min_seq in (0, int(b["min_seqs"][doc])):
        got = host.assemble_entries(b["packed"], b["payloads"], doc,
                                    min_seq=min_seq)
        want = jhost.assemble_entries(b["packed"], b["jpayloads"], doc,
                                      min_seq=min_seq)
        assert got == want
        assert len(got) == b["packed"][-1][doc]


@pytest.mark.parametrize("chunk_chars", [10_000, 8, 1])
def test_assemble_snapshot_matches_jax(chunk_chars):
    b = summary_batch()
    for doc in range(6):
        kw = dict(min_seq=int(b["min_seqs"][doc]), seq=int(b["seqs"][doc]),
                  chunk_chars=chunk_chars)
        got = host.assemble_snapshot(b["packed"], b["payloads"], doc, **kw)
        want = jhost.assemble_snapshot(b["packed"], b["jpayloads"], doc,
                                       **kw)
        assert got == want
        assert json.dumps(got) == json.dumps(want)
        assert got["header"]["chunkCount"] == len(got["chunks"]) >= 1
        assert host.flatten_snapshot_content(got) == \
            jhost.flatten_snapshot_content(want)
    if chunk_chars == 1:
        assert got["header"]["chunkCount"] > 1


def test_chunk_entries_and_flatten_match_jax():
    b = summary_batch()
    entries = host.assemble_entries(b["packed"], b["payloads"], 0)
    for size in (1, 3, 10, 10_000):
        assert host.chunk_entries(entries, size) == \
            jhost.chunk_entries(entries, size)
    assert host.chunk_entries([]) == jhost.chunk_entries([]) == [[]]
    snap = host.assemble_snapshot(b["packed"], b["payloads"], 0, 0, 99)
    flat = host.flatten_snapshot_content(snap)
    visible = [e for e in entries if e.get("removedSeq") is None]
    assert len(flat) == sum(1 if e["kind"] == SEG_MARKER
                            else len(e["text"]) for e in visible)
    assert snap["header"]["totalLength"] == len(flat)


# ---------------------------------------------------------------------------
# the catch-up narrow wire
# ---------------------------------------------------------------------------

def wire_entries():
    """Entries that reach every escape of the wire: a quote, a backslash,
    non-ASCII and a newline in the text; a marker; props; overlap
    clients; seqs and clients past int16; a wire-encoded Items payload."""
    return [
        {"kind": SEG_TEXT, "text": 'a"b\\cü\n', "seq": 5, "client": 0},
        {"kind": SEG_MARKER, "text": "", "props": {"tag": "p", "n": None}},
        {"kind": SEG_TEXT, "text": "zz", "seq": 70_000, "client": 40_000,
         "removedSeq": 70_001, "removedClient": 2,
         "removedOverlapClients": [3, -1, 50_000]},
        {"kind": SEG_TEXT, "text": {"items": [1, "x", None]}, "seq": 9,
         "client": 1, "removedSeq": 10},
        {"kind": SEG_TEXT, "text": "", "props": {"b": 1}},
    ]


def catchup_cases():
    small = encode_entry_payloads(golden.load_catchup()["small"]["entries"])
    return {"golden_small": (small, golden.CATCHUP_BLOB_BASE),
            "escapes": (wire_entries(), 12)}


@pytest.mark.parametrize("case", ["golden_small", "escapes"])
def test_pack_entries_narrow_matches_jax(case):
    entries, base = catchup_cases()[case]
    blob = catchup.pack_entries_narrow(entries, base)
    want = jcatchup.pack_entries_narrow(copy.deepcopy(entries), base)
    assert sorted(blob) == sorted(want)
    for key in want:
        assert blob[key] == want[key], key
    assert json.dumps(blob) == json.dumps(want)
    assert catchup.unpack_entries_narrow(blob) == entries
    assert catchup.unpack_entries_narrow(blob) == \
        jcatchup.unpack_entries_narrow(want)
    if case == "escapes":
        assert blob["seqX"] and blob["cliX"] and blob["payloads"]


def test_narrow_wire_refusals_match_jax():
    pending = [{"kind": SEG_TEXT, "text": "x", "localSeq": 1}]
    for mod in (catchup, jcatchup):
        with pytest.raises(ValueError, match="pending local state"):
            mod.pack_entries_narrow(pending, 0)
        blob = mod.pack_entries_narrow(wire_entries(), 12)
        with pytest.raises(ValueError, match="unknown catch-up wire"):
            mod.unpack_entries_narrow(dict(blob, v=99))
        with pytest.raises(ValueError, match="narrow column length"):
            mod.unpack_entries_narrow(dict(blob, n=blob["n"] + 1))


def test_translate_entry_clients_matches_jax():
    entries = wire_entries()
    mapping = {0: 10, 1: 11, 2: 12, 3: 13, 40_000: 14, 50_000: 15}
    got = catchup.translate_entry_clients(entries, mapping)
    assert got == jcatchup.translate_entry_clients(entries, mapping)
    assert got[2]["removedOverlapClients"] == [13, -1, 15]
    assert got[1] is entries[1] and got[4] is entries[4]   # untouched
    assert entries == wire_entries()                        # copies
    short = {0: 10, 1: 11}
    for mod in (catchup, jcatchup):
        with pytest.raises(KeyError):
            mod.translate_entry_clients(entries, short)
