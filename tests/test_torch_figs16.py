"""The paper's Fig. 1 as ``chip_smoke.py``'s figs phase computes it on
the port (``_fig1``), run here on the CPU under ``hw=V5E`` at the JAX
package's benchmark defaults, against the JAX package's
``benchmarks/fig1_motivation.py``: on gaussian3x3 (120 variants, 2 QoR
images) the fraction of ASIC-Pareto variants that are off the
deployment-energy front equals the one ``fig1_motivation.run`` returns.
The reference labels with XLA on the CPU; the port's labels under
``V5E`` are bit-identical to them, so the figure is equal exactly.
(Fig. 6 is ``tests/test_torch_fig6.py``'s.)"""

from benchmarks import fig1_motivation
from repro_torch.core.acl.library import default_library
from repro_torch.core.hw import V5E

from _chip_smoke_module import load_chip_smoke
from _torch_threads import bounded_torch_threads  # noqa: F401

chip_smoke = load_chip_smoke()
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
