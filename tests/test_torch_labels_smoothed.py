"""The smoothed DCT pipeline's labels in both packages on its fixed
16-genome set (``tests/_labels_family.py``; the other families and the
gaussian3x3 set are ``tests/test_torch_labels.py``'s): ``qor`` and
``energy`` bit-identical, ``flops`` (against the JAX package's per-stage
XLA counts) and ``hbm_bytes`` by rank order."""

import pytest

from _labels_family import check_bits, check_rank, family_labels  # noqa: F401
from _torch_threads import bounded_torch_threads  # noqa: F401


@pytest.mark.parametrize("key", ["qor", "energy"])
@pytest.mark.parametrize("name", ["smoothed_dct"])
def test_family_labels_bit_identical(family_labels, name, key):
    check_bits(family_labels, name, key)


@pytest.mark.parametrize("key", ["flops", "hbm_bytes"])
@pytest.mark.parametrize("name", ["smoothed_dct"])
def test_family_hardware_counts_keep_rank_order(family_labels, name, key):
    check_rank(family_labels, name, key)
