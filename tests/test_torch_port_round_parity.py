"""The port's round loop against the JAX package's over the recipe's 5
rounds, free-running (tools_dev/round_parity_port.py: run_al_rounds of
each package from one init, SGD, no weight synchronisation between
rounds, at the tiny sizes of test_torch_port_rounds.py): round 1's
selection JSON and datalist byte for byte, every round's selected
regions with Jaccard 1.0, and every round's step-0 loss within 1.5e-5
relative, the bound tools_dev/round_parity_multi.py gave in commit
fbc153b. Slow (a few minutes); run it with
python -m pytest tests/test_torch_port_round_parity.py.
"""

import pytest

pytestmark = pytest.mark.slow


def test_five_free_running_rounds_match_jax(tmp_path):
    from tools_dev.round_parity_port import run

    report = run(rounds=5, workdir=str(tmp_path), verbose=False)
    assert report["round1_identical"]
    rows = report["rounds"]
    assert [r["round"] for r in rows] == [1, 2, 3, 4, 5]
    for r in rows:
        assert r["n_selected"][1] > 0, r
        assert r["selection_jaccard"] == 1.0, r
        assert r["step0_rel"] <= 1.5e-5, r
