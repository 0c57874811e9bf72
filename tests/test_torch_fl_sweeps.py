"""A CPU smoke run of the port's homework A2/A3 sweep twin
(``examples/homework1_a2_a3_sweeps.py``): its quick grid on sklearn's real
digits, every accuracy in [0, 1], and more local epochs learning more per
round on the IID split."""

import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.examples import homework1_a2_a3_sweeps  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and torch's CPU kernels would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_twin_quick_digits():
    rows = homework1_a2_a3_sweeps.main(["--quick", "--data", "digits", "--device", "cpu"])
    # A2: 2 servers x (2 client counts + 2 fractions); A3: 2 splits x 2 epoch counts
    assert len(rows) == 12
    assert sum(r["part"] == "a3" for r in rows) == 4
    for r in rows:
        assert len(r["accuracy"]) == 3 and all(0.0 <= a <= 1.0 for a in r["accuracy"])
    a3 = {(r["iid"], r["E"]): r["accuracy"][-1] for r in rows if r["part"] == "a3"}
    assert a3[(True, 5)] > a3[(True, 1)]  # more local epochs learn more per round
