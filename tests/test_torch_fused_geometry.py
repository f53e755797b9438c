"""The fused apply's launch geometry (fluidframework_tpu_torch/mergetree/
pallas_apply.py launch_geometry) against the limits of one H100 and the
formulas of kernels/csrc/fused_apply.cu, on the CPU.

The kernel refuses a geometry that differs from its own formulas, so these
tests hold the Python rule to them: for every capacity the fused apply
takes, the chosen path's block fits the card's shared memory and the
kernel's launch bounds, and the main paths' shapes land on the paths
PERF.md names.
"""

import re
from pathlib import Path

import pytest

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.mergetree import pallas_apply as tpa
from fluidframework_tpu_torch.mergetree.state import make_state
from fluidframework_tpu_torch.testing.traces import gen_traces

SOURCE = Path(tpa.__file__).resolve().parents[1] / "kernels" / "csrc" / \
    "fused_apply.cu"
SMEM_PER_BLOCK = 232_448     # Hopper: 227 KB of dynamic shared memory
BLOCK_PATH_THREADS = 1024    # fused_apply_kernel_block's launch bounds


def cu_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("batch", [1, 128, 1024, 16384])
@pytest.mark.parametrize("k,a", [(3, 1), (3, 4), (8, 1), (1, 8)])
def test_every_capacity_fits(k, a, batch):
    planes = 8 + k + a
    warp_bound = 32 * cu_constant("kMaxDocsPerBlock")
    for c in range(1, tpa.max_fused_capacity(k, a) + 1):
        geo = tpa.launch_geometry(batch, c, k, a)
        assert geo.smem_bytes <= SMEM_PER_BLOCK, (c, geo)
        if geo.path == "warp":
            rows = -(-c // 32)  # one row of 32 slots per lane sweep
            doc = planes * rows * 32 * 4
            assert c <= tpa.WARP_MAX_CAPACITY
            assert batch >= tpa.WARP_MIN_DOCS
            # whole warps, one document each: no warp of a block waits on a
            # barrier that another warp's early exit would leave open
            assert 1 <= geo.docs_per_block <= tpa.MAX_DOCS_PER_BLOCK
            assert geo.docs_per_block == min(tpa.WARP_DOCS_PER_BLOCK,
                                             SMEM_PER_BLOCK // doc)
            assert geo.threads == 32 * geo.docs_per_block <= warp_bound
            assert geo.smem_bytes == geo.docs_per_block * doc
        else:
            assert c > tpa.WARP_MAX_CAPACITY or batch < tpa.WARP_MIN_DOCS
            assert geo.path == "block" and geo.docs_per_block == 1
            assert geo.threads == min(-(-c // 32) * 32, BLOCK_PATH_THREADS)
            assert geo.smem_bytes == (planes + 2) * c * 4 + 128 * 4


def test_python_limits_match_the_kernel_source():
    assert tpa.WARP_MAX_CAPACITY == 32 * cu_constant("kMaxRows")
    assert tpa.MAX_DOCS_PER_BLOCK == cu_constant("kMaxDocsPerBlock")
    assert BLOCK_PATH_THREADS == cu_constant("kMaxThreads")
    src = SOURCE.read_text()
    assert "__launch_bounds__(32 * kMaxDocsPerBlock)" in src
    warp = src[src.index("// WARP path: one warp per document, slot l"):
               src.index("// host side")]
    assert "fused_apply_kernel_warp" in warp
    assert "__syncthreads" not in warp  # warp primitives only
    assert tpa._PATHS == {"block": 0, "warp": 1}
    assert "enum Path { PATH_BLOCK = 0, PATH_WARP = 1 }" in src


# The main paths' shapes and the path PERF.md §6 gives each: the
# north-star apply and the serving ring's three page groups.
@pytest.mark.parametrize("batch,capacity,k,a,path", [
    (10_000, 256, 3, 1, "warp"),      # north-star plain apply
    (16_384, 64, 3, 4, "warp"),       # ring extract group
    (1_024, 256, 3, 4, "warp"),       # ring runs+extract group
    (128, 512, 3, 4, "block"),        # ring runs+extract storm group
    (1_024, 128, 3, 4, "warp"),       # ring 1's runs+extract groups
    (256, 256, 3, 4, "block"),
    (128, 64, 3, 4, "block"),         # few documents: block at any C
    (6, 1_100, 3, 2, "block"),        # above the warp path's reach
])
def test_main_path_shapes(batch, capacity, k, a, path):
    assert tpa.launch_geometry(batch, capacity, k, a).path == path


@pytest.mark.parametrize("batch,capacity,path", [
    (1, 64, "block"), (511, 1, "block"), (511, 512, "block"),
    (512, 1, "warp"), (512, 512, "warp"), (100_000, 513, "block")])
def test_rule_boundaries(batch, capacity, path):
    """The warp path from WARP_MIN_DOCS documents up to its reach in C;
    the block path for fewer documents or larger tables."""
    assert tpa.launch_geometry(batch, capacity, 3, 4).path == path


def test_max_fused_capacity_unchanged():
    assert tpa.max_fused_capacity(3, 1) == 4141
    assert tpa.max_fused_capacity(3, 4) == 3410


def test_out_of_range_and_forced_paths():
    with pytest.raises(ValueError):
        tpa.launch_geometry(4, 0, 3, 1)
    with pytest.raises(ValueError):
        tpa.launch_geometry(4, tpa.max_fused_capacity(3, 1) + 1, 3, 1)
    with pytest.raises(ValueError):
        tpa._forced_geometry("warp", tpa.WARP_MAX_CAPACITY + 1, 3, 1)
    with pytest.raises(ValueError):
        tpa._forced_geometry("lane", 64, 3, 1)
    block = tpa._forced_geometry("block", 64, 3, 1)
    assert block == tpa.Geometry("block", 1, 64, (8 + 3 + 1 + 2) * 64 * 4
                                 + 512)


def test_docs_per_block_spreads_small_batches():
    """The documents per block do not follow the batch: WARP_DOCS_PER_BLOCK
    wherever their tables fit one block's shared memory, fewer where they
    do not (C = 512 at 32 planes: 64 KB a document)."""
    w = tpa.WARP_DOCS_PER_BLOCK
    for batch in (512, 1_024, 16_384):
        assert tpa.launch_geometry(batch, 64, 3, 4).docs_per_block == w
    assert tpa._forced_geometry("warp", 512, 3, 4).docs_per_block == w
    assert tpa._forced_geometry("warp", 512, 8, 16).docs_per_block == \
        min(w, SMEM_PER_BLOCK // (32 * 512 * 4))


def test_cpu_wrapper_ignores_the_path_and_counts_nothing():
    """On CPU tensors the wrapper runs the plain version whatever path the
    rule names, and counts no launch; a forced launch (_launch) refuses
    CPU tensors."""
    state = make_state(64, 2, batch=3, device="cpu")
    ops = interop.packed_ops_from_numpy(gen_traces(3, 10, seed=4), "cpu")
    tpa.reset_launches()
    want = interop.to_numpy(tpa.apply_ops_fused_plain(state, ops))
    got = interop.to_numpy(tpa.apply_ops_fused(state, ops))
    for name in want:
        assert (got[name] == want[name]).all(), name
    for path in ("warp", "block"):
        with pytest.raises(ValueError, match="CUDA"):
            tpa._launch(state, ops, None, False,
                        tpa._forced_geometry(path, 64, 3, 2))
    assert tpa.apply_ops_fused.path_launches == {"block": 0, "warp": 0}
    assert tpa.apply_ops_fused.launches == 0
