"""Tutorial 1b, DP by weight averaging, on PyTorch.  The counterpart of
``examples/tutorial_1b/intro_dp_wa.py``.

The reference (``lab/tutorial_1b/DP/weight_aggr/intro_DP_WA.py:52-67``)
steps each rank's optimizer on its LOCAL gradients first, then averages the
weights.  (As written the reference's sync is a silent no-op: ``param ==
None`` is always False and the loop rebinds its variable; this implements
its intent, as the JAX package does.)  Here each spawned rank runs
:func:`~ddl25spring_tpu_torch.parallel.dp.make_dp_weight_avg_step`: its own
Adam step, then the mean of the weights over the replicas; everything else
is :mod:`~ddl25spring_tpu_torch.examples.tutorial_1b.intro_dp_ga`'s.

Run: ``python -m ddl25spring_tpu_torch.examples.tutorial_1b.intro_dp_wa
[--iters 20] [--ranks 2] [--device cpu]``
"""

from __future__ import annotations

from ddl25spring_tpu_torch.examples.tutorial_1b.intro_dp_ga import run


def main(argv=None) -> dict:
    return run(argv, weight_avg=True, doc=__doc__)


if __name__ == "__main__":
    main()
