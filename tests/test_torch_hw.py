"""The port's hardware cost models: the H100 constants the labels use by
default, the JAX package's TPU v5e model kept for parity, the dtype cost
factors, and energy following the constants a roofline was built with."""

import numpy as np
import pytest

from repro.core import hw as ref_hw
from repro_torch.accel import GaussianFilter
from repro_torch.core import hw
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()


def test_h100_constants_are_the_data_sheet_rates():
    h = hw.H100_SXM
    assert isinstance(h, hw.H100)
    assert (h.peak_bf16_flops, h.peak_int8_ops) == (989e12, 1979e12)
    assert (h.hbm_bw, h.hbm_bytes, h.power_limit_w) == (3.35e12, 80e9, 700.0)
    # published energies: a bf16 MAC (fp16 multiply 1.1 pJ + fp32 add
    # 0.9 pJ, Horowitz ISSCC 2014) over its 2 FLOPs; HBM2's 3.9 pJ/bit
    assert h.e_flop == pytest.approx(1.0e-12, rel=1e-12)
    assert h.e_hbm_byte == pytest.approx(31.2e-12, rel=1e-12)
    # the NVLink energy is derived (power limit over rate)
    assert h.e_ici_byte == h.power_limit_w / h.ici_bw


@pytest.mark.parametrize("width,factor", [
    (2, 989 / 1979), (4, 989 / 1979), (7, 989 / 1979), (8, 989 / 1979),
    (9, 1.0), (16, 1.0),
])
def test_h100_dtype_cost_factor_has_no_int4_path(width, factor):
    assert hw.H100_SXM.dtype_cost_factor(width) == pytest.approx(
        factor, rel=1e-15)


@pytest.mark.parametrize("width,factor", [
    (2, (0.2 / 16 + 0.1) / 2.0), (4, (0.2 / 4 + 0.1) / 2.0),
    (7, (0.2 * 49 / 64 + 0.1) / 2.0), (8, 0.3 / 2.0), (9, 1.0), (16, 1.0),
])
def test_h100_energy_factor_counts_the_operand_width(width, factor):
    # Horowitz's int8 multiply at (width/8)^2 plus the int32 accumulate,
    # over a bf16 MAC's 2.0 pJ
    assert hw.H100_SXM.energy_factor(width) == pytest.approx(factor,
                                                             rel=1e-12)


def test_h100_energy_grows_with_width_where_time_does_not():
    h = hw.H100_SXM
    e = [h.energy_factor(w) for w in range(1, 9)]
    assert all(a < b for a, b in zip(e, e[1:]))
    assert len({h.dtype_cost_factor(w) for w in range(1, 9)}) == 1


@pytest.mark.parametrize("width", [2, 4, 6, 8, 12])
def test_v5e_is_the_reference_model(width):
    assert hw.V5E.dtype_cost_factor(width) == \
        ref_hw.V5E.dtype_cost_factor(width)
    # the reference charges energy at the time factor
    assert hw.V5E.energy_factor(width) == hw.V5E.dtype_cost_factor(width)
    for k in ("peak_bf16_flops", "hbm_bw", "e_flop", "e_hbm_byte",
              "e_ici_byte"):
        assert getattr(hw.V5E, k) == getattr(ref_hw.V5E, k)


def test_roofline_energy_follows_its_hw():
    args = (3.0e9, 2.0e6, 5.0e3)
    for h in (hw.H100_SXM, hw.V5E):
        rt = hw.roofline(*args, hw=h)
        assert rt.hw is h
        assert rt.energy == (args[0] * h.e_flop + args[1] * h.e_hbm_byte
                             + args[2] * h.e_ici_byte)
        assert rt.t_compute == args[0] / h.peak_bf16_flops
        assert rt.t_memory == args[1] / h.hbm_bw
    assert hw.roofline(*args).hw is hw.H100_SXM
    want = ref_hw.roofline(*args)
    assert hw.roofline(*args, hw=hw.V5E).as_dict() == want.as_dict()


def test_labels_default_to_h100_and_v5e_is_the_switch():
    accel = GaussianFilter()
    sizes = accel.gene_sizes(LIB)
    g = np.random.default_rng(3).integers(0, sizes[None, :],
                                          size=(6, len(sizes)))
    x = accel.sample_inputs(1, seed=synth.DEFAULT_QOR_SEED)
    h100 = synth.label_variants(accel, g, LIB, qor_inputs=x, device="cpu")
    v5e = synth.label_variants(accel, g, LIB, qor_inputs=x, device="cpu",
                               hw=hw.V5E)
    assert h100["qor"].tobytes() == v5e["qor"].tobytes()
    for k in ("flops", "hbm_bytes"):
        assert np.array_equal(h100[k], v5e[k])
    variants = [accel.decode(row, LIB) for row in g]
    for t, (circuits, ranks) in enumerate(variants):
        for h, labels in ((hw.H100_SXM, h100), (hw.V5E, v5e)):
            rec = synth.synthesize_batch(accel, [(circuits, ranks)],
                                         device="cpu", hw=h)[0]
            adj = synth._adjusted_compute(accel, circuits, ranks,
                                          h.dtype_cost_factor)
            assert rec["mxu_flops_adjusted"] == adj
            assert labels["energy"][t] == rec["energy"]
            assert labels["latency"][t] == (adj / h.peak_bf16_flops
                                            + rec["hbm_bytes"] / h.hbm_bw)
    assert not np.array_equal(h100["energy"], v5e["energy"])


def _truncated(accel, width):
    """The exact gaussian3x3 genome with its first multiplier replaced by
    the unsigned truncation of native ``width``."""
    g = accel.exact_genome(LIB)
    muls = LIB.kind("mul8u")
    g[accel.mul_slot_indices()[0]] = next(
        i for i, c in enumerate(muls) if c.native_width == width)
    return g


@pytest.mark.parametrize("width", [2, 4, 6, 7])
def test_h100_truncation_costs_less_energy_than_exact(width):
    """On the H100 model every truncation saves energy (its front keeps
    approximate designs); on v5e only widths up to 4 do."""
    accel = GaussianFilter()
    g = np.stack([accel.exact_genome(LIB), _truncated(accel, width)])
    x = accel.sample_inputs(1, seed=synth.DEFAULT_QOR_SEED)
    h100 = synth.label_variants(accel, g, LIB, qor_inputs=x, device="cpu")
    v5e = synth.label_variants(accel, g, LIB, qor_inputs=x, device="cpu",
                               hw=hw.V5E)
    assert h100["energy"][1] < h100["energy"][0]
    assert h100["latency"][1] == h100["latency"][0]
    assert (v5e["energy"][1] < v5e["energy"][0]) == (width <= 4)


def test_one_synthesis_cache_serves_both_cost_models():
    accel = GaussianFilter()
    sizes = accel.gene_sizes(LIB)
    g = np.random.default_rng(4).integers(0, sizes[None, :],
                                          size=(5, len(sizes)))
    x = accel.sample_inputs(1, seed=synth.DEFAULT_QOR_SEED)
    shared = {}
    for h in (hw.V5E, hw.H100_SXM, hw.V5E):
        got = synth.label_variants(accel, g, LIB, qor_inputs=x,
                                   cache=shared, device="cpu", hw=h)
        want = synth.label_variants(accel, g, LIB, qor_inputs=x,
                                    cache={}, device="cpu", hw=h)
        for k in ("energy", "latency", "flops", "hbm_bytes"):
            assert got[k].tobytes() == want[k].tobytes(), (h, k)
    assert len(shared) == len({tuple(r) for r in g})
