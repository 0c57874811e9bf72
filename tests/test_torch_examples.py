"""CPU smoke runs of the port's tutorial_1b twins (DP gradient aggregation,
DP weight averaging, the 3-stage 1F1B chain) at ctx 16 for 2 steps: losses
finite and falling; the 1F1B chain's steps equal the same steps under GPipe
(rtol 1e-6)."""

import math

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.examples.tutorial_1b import (  # noqa: E402
    intro_dp_ga,
    intro_dp_wa,
    intro_pp_1f1b,
)

TINY_RUN = ["--device", "cpu", "--iters", "2", "--seq-len", "16"]


@pytest.mark.parametrize("twin", [intro_dp_ga, intro_dp_wa], ids=["ga", "wa"])
def test_dp_twins_train(twin):
    run = twin.main(TINY_RUN)
    assert len(run["losses"]) == 2 and all(math.isfinite(x) for x in run["losses"])
    assert run["losses"][1] < run["losses"][0]
    # every replica reports the same mean loss
    assert all(r["losses"] == run["losses"] for r in run["ranks"])
    assert {r["backend"] for r in run["ranks"]} == {"gloo"}


def test_pp_1f1b_twin_equals_gpipe():
    run = intro_pp_1f1b.main(TINY_RUN)
    gpipe = intro_pp_1f1b.main(TINY_RUN + ["--schedule", "gpipe"])
    assert len(run["losses"]) == 2 and all(math.isfinite(x) for x in run["losses"])
    assert run["losses"] == pytest.approx(gpipe["losses"], rel=1e-6)
    assert [r["stash_max"] for r in run["ranks"]] == [[1, 1]] * 3  # M = 1
