"""The paper's Figs. 1 and 6 as ``chip_smoke.py``'s figs phase computes them
on the port (``_fig1``, ``_fig6``), run here on the CPU under ``hw=V5E``
at the JAX package's benchmark defaults, against the JAX package's
``benchmarks/fig1_motivation.py`` and ``benchmarks/fig6_models.py``:

* Fig. 1 on gaussian3x3 (120 variants, 2 QoR images): the fraction of
  ASIC-Pareto variants that are off the deployment-energy front equals
  the one ``fig1_motivation.run`` returns;
* Fig. 6 on mcm1-mcm4 (60 training and 30 test genomes a row): every
  PCC of random forest, Bayesian ridge and SVR on pipeline D, for QoR and
  energy, equals the value ``fig6_models.run`` emits (rounded there to 3
  digits), and the best model of each row is the same.

Both reference runs label with XLA on the CPU; the port's labels under
``V5E`` are bit-identical to them, so the figures are equal exactly.
``_fig6`` fits in the spawned processes it uses on the card."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmarks import fig1_motivation, fig6_models
from repro_torch.core.acl.library import default_library
from repro_torch.core.hw import V5E


def _load_chip_smoke():
    """The script as the module ``chip_smoke``, registered so that the
    processes ``_fig6`` spawns can unpickle its functions by name (they
    import it from the repo root, put on their path)."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    return mod


chip_smoke = _load_chip_smoke()
LIB = default_library()


def test_fig1_mismatch_equals_reference(capsys):
    want = fig1_motivation.run(n_variants=120, seed=0, qor_samples=2)
    total: dict = {}
    got = chip_smoke._fig1(LIB, 0, total, n_variants=120, qor_samples=2,
                           device="cpu", hw=V5E)
    capsys.readouterr()
    assert got["pareto_mismatch_fraction"] == want
    assert got["n_variants"] == 120 and got["hw"] == "v5e"
    assert got["asic_front_size"] > 0 and got["hw_front_size"] > 0
    # the CPU runs the kernels' plain versions: no launch is counted
    assert all(v == 0 for v in total.values())


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
