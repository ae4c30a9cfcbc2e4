"""How the port's analytic deployment count (``accel/lm.py``
``deploy_cost``) ranks an LM's designs against XLA's ``cost_analysis``
in the JAX package, on the CPU, at the reduced config (not a test):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_cost_rank.py \\
        --arch seamless-m4t-medium --genomes 8 --seed 7

Both accelerators run on the JAX package's parameters (carried across by
``convert.lm_params_from_numpy``), the genomes are
``tests/test_torch_lm_dse.py``'s ``_genomes`` (the exact design first,
then numpy-seeded ones), and both are labeled under ``hw=V5E``.  Prints,
for ``flops`` and ``hbm_bytes``, the port/XLA ratio's range and
Spearman's rho between the two, and whether energy is bit-identical.
``repro`` compiles each design with XLA: about 8 s a genome."""

import argparse
import sys
from pathlib import Path

import jax
import numpy as np
from scipy.stats import spearmanr

sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro.accel.lm import LMAccelerator as RefLM  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.acl.library import default_library as ref_library  # noqa: E402
from repro.core.features import synth as ref_synth  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.accel import LMAccelerator  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.acl.library import default_library  # noqa: E402
from repro_torch.core.features import synth  # noqa: E402
from repro_torch.core.hw import V5E  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from test_torch_lm_dse import _genomes  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seamless-m4t-medium")
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    racc = RefLM(ref_get_config(args.arch))
    tree = jax.tree.map(np.asarray, racc._ensure_params())
    cfg = get_config(args.arch)
    acc = LMAccelerator(cfg, device="cpu",
                        params=convert.lm_params_from_numpy(tree, reduced(cfg)))
    g = _genomes(acc, args.genomes, seed=args.seed)
    inputs = acc.sample_inputs(2, seed=1234)
    ref_synth.reset_fast_codegen()
    rlab = ref_synth.label_variants(racc, g, ref_library(), qor_inputs=inputs)
    lab = synth.label_variants(acc, g, default_library(), qor_inputs=inputs,
                               device="cpu", hw=V5E,
                               synth_cache=synth.SynthCache())
    print(f"{args.arch}: {len(g)} genomes (seed {args.seed}); energy "
          f"bit-identical {np.array_equal(lab['energy'], rlab['energy'])}; "
          f"QoR max |diff| {np.max(np.abs(lab['qor'] - rlab['qor'])):.3f} dB")
    for k in ("flops", "hbm_bytes"):
        ratio = lab[k] / rlab[k]
        print(f"  {k}: port/XLA {ratio.min():.3f}..{ratio.max():.3f}, "
              f"spearman {spearmanr(lab[k], rlab[k])[0]:.3f}")


if __name__ == "__main__":
    main()
