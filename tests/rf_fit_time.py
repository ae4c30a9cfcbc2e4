"""Seconds of one random-forest fit (the paper's QoR surrogate: 50
trees, depth 12) at the paper's 1000 training genomes, in the JAX
package's copy (a split search that loops over the features) and in the
port's (all candidate features scored in one 2-D pass), on the same
data, with the two forests' predictions compared bit for bit.  Not a
test; run on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rf_fit_time.py

One JSON line a feature count."""

import json
import time

import numpy as np

from repro.core.surrogates import make as ref_make
from repro_torch.core.surrogates import make


def _fit_s(factory, X, y):
    t0 = time.perf_counter()
    model = factory("random_forest", seed=0).fit(X, y)
    return time.perf_counter() - t0, model


def main() -> None:
    rng = np.random.default_rng(0)
    for d in (10, 30, 60):
        X = rng.integers(0, 8, (1000, d)) / 7.0
        y = X @ rng.standard_normal(d) + rng.standard_normal(1000)
        probe = rng.integers(0, 8, (500, d)) / 7.0
        ref_s, ref = _fit_s(ref_make, X, y)
        port_s, port = _fit_s(make, X, y)
        same = ref.predict(probe).tobytes() == port.predict(probe).tobytes()
        print(json.dumps({"n_train": 1000, "features": d,
                          "reference_fit_s": ref_s, "port_fit_s": port_s,
                          "same_predictions": same}))


if __name__ == "__main__":
    main()
