"""The port's LM DSE against the JAX package's on falcon-mamba-7b
at the reduced config: QoR, the hardware labels under ``hw=V5E`` and
``policy_for_genome`` (``tests/_lm_dse_pair.py``; the other checks are
``tests/test_torch_lm_dse.py``'s)."""

import pytest

from _lm_dse_pair import (  # noqa: F401  (the pair tests, collected here)
    make_pair, test_hw_labels_match_reference_under_v5e,
    test_policy_for_genome_matches_reference, test_qor_batch_matches_reference)
from _torch_threads import bounded_torch_threads  # noqa: F401


@pytest.fixture(scope="module", params=["falcon-mamba-7b"])
def pair(request):
    return make_pair(request.param)
