"""The committed local-server golden (fluidframework_tpu_torch/testing/
golden/server_golden.json): the JAX package's TpuLocalServer through
testing/server_runs.py, as digests.

chip_smoke.py phase 17 holds the port's local server on the card against
its card section (golden.SERVER_CARD: 512 documents x 32 ops a wave,
bucketed and paged). Here the file's invariants are checked, and the
port's server on the CPU is held against its small section; the rebuild
of the whole file from JAX takes minutes and is marked slow. Regenerate
the file only on a deliberate change of the scenario:

    JAX_PLATFORMS=cpu python tests/test_torch_server_golden.py --write
"""

from __future__ import annotations

import sys

import pytest

from fluidframework_tpu_torch.testing import golden, server_runs

from test_torch_local_server import jax_package, port_package

CARD = server_runs.Spec(**golden.SERVER_CARD)
SMALL = server_runs.Spec(**golden.SERVER_SMALL)


def build_server_golden(pkg) -> dict:
    return {"card": {layout: server_runs.run(
        pkg, CARD, **server_runs.VARIANTS[layout])
        for layout in ("bucketed", "paged")},
        "small": {variant: server_runs.run(pkg, SMALL, **kw)
                  for variant, kw in server_runs.VARIANTS.items()}}


class TestServerGolden:
    def test_golden_covers_the_hard_cases(self):
        g = golden.load_server()
        for layout in ("bucketed", "paged"):
            card = g["card"][layout]
            assert card["docs"] == CARD.docs
            assert card["waves"] == CARD.warm + CARD.measured + CARD.extra
            assert card["admission_nacks"] == 0 and card["nack_count"] == 0
            assert card["shed"] == 0
            assert card["readers"] == CARD.docs // CARD.reader_every
            assert card["reader_messages"] > 0
            assert card["summaries_acked"] == \
                CARD.docs // CARD.summary_every
            assert card["catchup_docs"] == CARD.docs // CARD.catchup_every
            assert card["refreshed"]["published"] > 0
            assert card["materialized_docs"] == CARD.docs
        assert g["card"]["bucketed"]["promoted"] > 0
        # The layouts and the runners agree on everything a client sees.
        for key in ("streams", "nacks", "deltas", "texts", "checkpoints",
                    "summaries"):
            assert g["card"]["bucketed"][key] == g["card"]["paged"][key]
            assert len({g["small"][v][key] for v in ("bucketed", "paged",
                                                     "overlapped")}) == 1

    @pytest.mark.parametrize("variant", ["bucketed", "paged"])
    def test_port_small_matches_golden(self, variant):
        got = server_runs.run(port_package(), SMALL,
                              **server_runs.VARIANTS[variant])
        assert got == golden.load_server()["small"][variant]

    @pytest.mark.slow
    def test_committed_file_matches_jax(self):
        assert build_server_golden(jax_package()) == golden.load_server()


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_server_golden.py --write")
    from fluidframework_tpu.core.platform import force_host_platform
    force_host_platform(1)
    golden.save_server(build_server_golden(jax_package()))
    print(f"wrote {golden.SERVER_GOLDEN_PATH} "
          f"({golden.SERVER_GOLDEN_PATH.stat().st_size} bytes)")
