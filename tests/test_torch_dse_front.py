"""The port's ``run_dse`` against the JAX package's on gaussian3x3 and
the MCM row mcm2, both labeling on the JAX package's cost model
(``hw=V5E``) on the CPU: the same training genomes and labels, the same
front and the same validation PCC, bit for bit (the rest of the DSE's
checks are ``tests/test_torch_dse.py``'s)."""

import numpy as np

from repro.accel import GaussianFilter as RefGaussian
from repro.accel import MCMAccelerator as RefMCM
from repro.core import dse as ref_dse
from repro.core.acl.library import default_library as ref_library
from repro.core.nsga2 import NSGA2Config as RefNSGA2Config
from repro_torch.accel import GaussianFilter, MCMAccelerator
from repro_torch.core import dse
from repro_torch.core.acl.library import default_library
from repro_torch.core.hw import V5E
from repro_torch.core.nsga2 import NSGA2Config

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()

SMALL = dict(n_train=24, n_qor_samples=2)
SMALL_NSGA = dict(pop_size=16, n_parents=8, n_generations=2)


def _front_identical(accel, ref):
    """run_dse of the port, labeling on the JAX package's cost model
    (``hw=V5E``) on the CPU, against the JAX package's run_dse."""
    labeler = dse.default_labeler(accel, LIB,
                                  n_qor_samples=SMALL["n_qor_samples"],
                                  device="cpu", hw=V5E)
    got = dse.run_dse(accel, LIB,
                      dse.DSEConfig(**SMALL, nsga=NSGA2Config(**SMALL_NSGA)),
                      labeler=labeler, device="cpu")
    want = ref_dse.run_dse(ref, RLIB, ref_dse.DSEConfig(
        **SMALL, nsga=RefNSGA2Config(**SMALL_NSGA)))
    assert np.array_equal(got.front_genomes, want.front_genomes)
    assert got.front_objectives.tobytes() == want.front_objectives.tobytes()
    assert np.array_equal(got.train_genomes, want.train_genomes)
    for k in ("qor", "energy"):
        assert got.train_labels[k].tobytes() == want.train_labels[k].tobytes()
    assert got.val_pcc == want.val_pcc


def test_run_dse_front_identical_to_reference():
    _front_identical(GaussianFilter(), RefGaussian())


def test_run_dse_front_identical_to_reference_mcm2():
    _front_identical(MCMAccelerator(1), RefMCM(1))
