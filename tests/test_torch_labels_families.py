"""The MCM rows' and the HEVC DCT's labels in both packages on their
fixed sets (``tests/_labels_family.py``; the gaussian3x3 set is
``tests/test_torch_labels.py``'s, the smoothed DCT's
``tests/test_torch_labels_smoothed.py``'s): ``qor`` and ``energy``
bit-identical, ``flops`` and ``hbm_bytes`` by rank order."""

import pytest

from _labels_family import check_bits, check_rank, family_labels  # noqa: F401
from _torch_threads import bounded_torch_threads  # noqa: F401

NAMES = ["mcm1", "mcm2", "mcm3", "mcm4", "hevc_dct4x4"]


@pytest.mark.parametrize("key", ["qor", "energy"])
@pytest.mark.parametrize("name", NAMES)
def test_family_labels_bit_identical(family_labels, name, key):
    check_bits(family_labels, name, key)


@pytest.mark.parametrize("key", ["flops", "hbm_bytes"])
@pytest.mark.parametrize("name", NAMES)
def test_family_hardware_counts_keep_rank_order(family_labels, name, key):
    check_rank(family_labels, name, key)
