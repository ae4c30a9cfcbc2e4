"""The paper's Fig. 6 as ``chip_smoke.py``'s figs phase computes it on the
port (``_fig6``), run here on the CPU under ``hw=V5E`` at the JAX
package's benchmark defaults, against the JAX package's
``benchmarks/fig6_models.py``: on mcm1-mcm4 (60 training and 30 test
genomes a row) every PCC of random forest, Bayesian ridge and SVR on
pipeline D, for QoR and energy, equals the value ``fig6_models.run``
emits (rounded there to 3 digits), and the best model of each row is
the same.  ``_fig6`` fits in the spawned processes it uses on the card.
(Fig. 1 is ``tests/test_torch_figs16.py``'s.)"""

import numpy as np

from benchmarks import fig6_models
from repro_torch.core.acl.library import default_library
from repro_torch.core.hw import V5E

from _chip_smoke_module import load_chip_smoke
from _torch_threads import bounded_torch_threads  # noqa: F401

chip_smoke = load_chip_smoke()
LIB = default_library()


def test_fig6_pccs_equal_reference(monkeypatch, capsys):
    emitted = {}
    monkeypatch.setattr(fig6_models, "emit",
                        lambda name, _us, derived: emitted.__setitem__(
                            name, derived))
    want_best = fig6_models.run(n_train=60, n_test=30, seed=0)
    got = chip_smoke._fig6(LIB, 0, {}, n_train=60, n_test=30, device="cpu",
                           hw=V5E)
    capsys.readouterr()
    assert got["not_scored"] == {}
    n = 0
    for row in range(4):
        key = f"mcm{row + 1}"
        for target in ("qor", "energy"):
            for name in chip_smoke.FIG6_MODELS:
                v = got["pcc"][key][target][name]
                assert np.isfinite(v)
                assert round(v, 3) == emitted[f"fig6.{key}.{target}.{name}"]
                n += 1
            assert got["best"][target][key] == want_best[target][row]
    assert n == 24
    assert got["rf_wins_qor_of4"] == emitted["fig6.rf_wins_qor_of4"]
    assert (got["bayes_wins_energy_of4"]
            == emitted["fig6.bayes_wins_energy_of4"])


def test_fig6_reports_an_unscorable_model(monkeypatch):
    """A model that is singular or predicts non-finite values is printed
    with its reason, not replaced."""
    X = np.random.default_rng(0).standard_normal((12, 3))
    y = X[:, 0].copy()

    class _Singular:
        def fit(self, *a):
            raise np.linalg.LinAlgError("Singular matrix")

    class _NaN:
        def fit(self, *a):
            return self

        def predict(self, X):
            return np.full(len(X), np.nan)

    import repro_torch.core.surrogates as surrogates

    for model, why in ((_Singular(), "singular"), (_NaN(), "non-finite")):
        monkeypatch.setattr(surrogates, "make", lambda *a, m=model, **k: m)
        v, reason = chip_smoke._fig6_score("svr", 0, X, y, 8)
        assert v is None and why in reason
    monkeypatch.undo()
    v, reason = chip_smoke._fig6_score("svr", 0, X, y, 8)
    assert reason is None and np.isfinite(v)
