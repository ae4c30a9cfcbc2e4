"""The port's DSE helpers against the JAX package's (its ``run_dse``
fronts are ``tests/test_torch_dse_front.py``'s), and the port's
isolation: it imports neither JAX nor the JAX package, and its entry
points refuse to run on a machine without a GPU unless asked for the
CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.acl.library import default_library as ref_library
from repro_torch import convert
from repro_torch.accel import GaussianFilter, HEVCDct
from repro_torch.core import dse
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth
from repro_torch.core.nsga2 import NSGA2Config

from _torch_threads import bounded_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LIB = default_library()
RLIB = ref_library()

SMALL = dict(n_train=24, n_qor_samples=2)
SMALL_NSGA = dict(pop_size=16, n_parents=8, n_generations=2)


def test_label_unique_scatters_back():
    calls = []

    def labeler(genomes):
        calls.append(len(genomes))
        return {"qor": genomes.sum(axis=1).astype(np.float64)}

    g = np.array([[1, 2], [0, 0], [1, 2], [3, 1]])
    out = dse.label_unique(labeler, g)
    assert calls == [3]
    assert np.array_equal(out["qor"], [3.0, 0.0, 3.0, 4.0])


def test_library_arrays_equal_across_packages():
    mine = convert.library_arrays(LIB)
    ref = convert.library_arrays(RLIB)
    assert sorted(mine) == sorted(ref)
    for k in mine:
        assert mine[k].dtype == ref[k].dtype, k
        assert mine[k].tobytes() == ref[k].tobytes(), k


_ISOLATION = """
import sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(1)
import repro_torch
from repro_torch.core.dse import run_dse, default_labeler
from repro_torch.core.features.synth import label_variants
from repro_torch.accel import GaussianFilter
from repro_torch import convert, _build
from repro_torch.kernels import approx_matmul, population_lut
from repro_torch.core import strategies, surrogates
from repro_torch.kernels import flash_attention, selective_scan
from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.launch.serve import serve_batch
from repro_torch import faults, obs, segments
from repro_torch.core.features.synth import JsonlSynthCache
from repro_torch.accel import LMAccelerator
from repro_torch.launch import dse_lm
from repro_torch.launch.serve import policy_from_front
from repro_torch.serving import FrontCatalog
from repro_torch.service import make_accelerator
from repro_torch.service import api, workers
from repro_torch.service.__main__ import main as service_main
from repro_torch.fleet import FleetCoordinator, protocol, leases, http
from repro_torch.fleet.worker import FleetWorker
from repro_torch.serving import ServingEngine, ServingHub, SimBackend
from repro_torch.launch import dse_hier
import os, tempfile
import numpy as np
acc = GaussianFilter()
lib = repro_torch.core.acl.library.default_library()
g = np.stack([acc.exact_genome(lib)] * 2)
labels = default_labeler(acc, lib, n_qor_samples=1, device="cpu")(g)
assert labels["qor"][0] == 100.0
cache = JsonlSynthCache(os.path.join(tempfile.mkdtemp(), "synth.jsonl"))
labels = default_labeler(acc, lib, n_qor_samples=1, synth_cache=cache,
                         device="cpu")(g)
assert labels["qor"][0] == 100.0 and cache.stats()["compiles"] == 1
cache.close()
for arch in ("falcon-mamba-7b", "granite-8b", "granite-moe-3b-a800m",
             "jamba-1.5-large-398b", "seamless-m4t-medium", "qwen2-vl-72b"):
    tokens, _ = serve_batch(reduced(get_config(arch)), batch=2, prompt_len=8,
                            gen=3, device="cpu")
    assert tuple(tokens.shape) == (2, 11)
    lm = make_accelerator("lm:" + arch, device="cpu")
    g = np.stack([lm.exact_genome(lib)] * 2)
    g[1, 0] = 1
    labels = default_labeler(lm, lib, n_qor_samples=1, device="cpu")(g)
    assert labels["qor"][0] == 100.0 and labels["qor"][1] < 100.0
from repro_torch.service import CampaignManager, CampaignSpec
from repro_torch.service.api import Client, make_server
import threading
mgr = CampaignManager(eval_backend="process", process_workers=1,
                      device="cpu")
srv = make_server(mgr, port=0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
cli = Client("http://127.0.0.1:%d" % srv.server_address[1])
cid = cli.submit(accel="mcm2", n_train=8, n_qor_samples=1, pop_size=8,
                 n_parents=4, n_generations=1)
assert cli.wait(cid, timeout=300)["state"] == "done"
assert cli.stats()["scheduler"]["process_batches"] > 0
x = make_accelerator("mcm2").sample_inputs(2, seed=1)
assert cli.serve("mcm2", x, tier="budget")["qor"] > 0
srv.shutdown()
mgr.shutdown()
from repro_torch import convert
from repro_torch.checkpoint import ckpt, run_resilient
from repro_torch.data import TokenPipeline
from repro_torch.launch.train import main as train_main
from repro_torch.optim import AdamW, ef_quantize
train_main(["--arch", "gemma-2b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "8", "--n-micro", "2", "--compress", "--ckpt-dir",
            os.path.join(tempfile.mkdtemp(), "ck"), "--device", "cpu"])
train_main(["--arch", "seamless-m4t-medium", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "8", "--device", "cpu"])
from repro_torch.dist import compat, sharding
from repro_torch.launch import cluster, mesh, shapes
shapes.input_specs(get_config("qwen2-vl-72b"), "train_4k",
                   type("Mesh", (), dict(shape=dict(data=16, model=16)))())
cluster.main(["--arch", "gemma-2b", "--reduced", "--steps", "2", "--batch",
              "2", "--seq", "8", "--compress", "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_reference():
    """A subprocess, because this test process has already imported
    both (tests/conftest.py imports the JAX package)."""
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATION.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)(?!_))",
    re.MULTILINE)


def test_static_scan_finds_no_reference_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    # the training slice's subpackages and modules are in the scan
    scanned = {str(p.relative_to(ROOT / "src" / "repro_torch"))
               for p in files[:-1]}
    assert {"data/pipeline.py", "optim/adamw.py", "optim/compress.py",
            "train/step.py", "checkpoint/ckpt.py",
            "checkpoint/fault_tolerance.py", "launch/train.py",
            "configs/seamless_m4t_medium.py",
            "configs/qwen2_vl_72b.py", "dist/sharding.py", "dist/compat.py",
            "launch/mesh.py", "launch/shapes.py",
            "launch/cluster.py"} <= scanned
    hits = []
    for p in files:
        for m in _FORBIDDEN.finditer(p.read_text()):
            hits.append(f"{p.relative_to(ROOT)}: {m.group(0).strip()}")
    assert hits == []
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    from repro.core import qor")
    assert not _FORBIDDEN.search("from repro_torch.core import qor")


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Transformer, reduced
    from repro_torch.train.serve import Generator

    lm = reduced(get_config("granite-8b"))
    acc = GaussianFilter()
    g = acc.exact_genome(LIB)[None]
    x = acc.sample_inputs(1)
    dct = HEVCDct()
    g_dct = dct.exact_genome(LIB)[None]
    from repro_torch.accel import LMAccelerator

    lm_acc = LMAccelerator(get_config("granite-8b"))
    g_lm = lm_acc.exact_genome(LIB)[None]
    from repro_torch.fleet.worker import FleetWorker
    from repro_torch.serving import ServingEngine
    from repro_torch.service import CampaignManager, ProcessPoolLabeler
    from repro_torch.launch.train import train_loop

    return {
        "default_labeler": lambda: dse.default_labeler(acc, LIB),
        "label_variants": lambda: synth.label_variants(acc, g, LIB,
                                                       qor_inputs=x),
        "qor_batch": lambda: acc.qor_batch(g, LIB, x),
        "simulate_batch": lambda: acc.simulate_batch(g, LIB, x),
        "hevc_qor_batch": lambda: dct.qor_batch(g_dct, LIB, x),
        "hevc_simulate_batch": lambda: dct.simulate_batch(g_dct, LIB, x),
        "run_dse": lambda: dse.run_dse(acc, LIB, dse.DSEConfig(
            **SMALL, nsga=NSGA2Config(**SMALL_NSGA))),
        "serve_batch": lambda: serve_batch(lm, batch=1, prompt_len=4, gen=2),
        "Generator": lambda: Generator(Transformer(lm)),
        "lm_qor_batch": lambda: lm_acc.qor_batch(
            g_lm, LIB, lm_acc.sample_inputs(1)),
        "lm_label_variants": lambda: synth.label_variants(
            lm_acc, g_lm, LIB, qor_inputs=lm_acc.sample_inputs(1)),
        "ProcessPoolLabeler": lambda: ProcessPoolLabeler(1),
        "process_backend_manager": lambda: CampaignManager(
            eval_backend="process"),
        "FleetWorker": lambda: FleetWorker("http://127.0.0.1:1"),
        "ServingEngine": lambda: ServingEngine(acc, LIB),
        "train_loop": lambda: train_loop(lm, steps=1, batch=1, seq=4),
    }


@pytest.mark.parametrize("name", ["default_labeler", "label_variants",
                                  "qor_batch", "simulate_batch", "run_dse",
                                  "serve_batch", "Generator",
                                  "hevc_qor_batch", "hevc_simulate_batch",
                                  "lm_qor_batch", "lm_label_variants",
                                  "ProcessPoolLabeler",
                                  "process_backend_manager", "FleetWorker",
                                  "ServingEngine", "train_loop"])
def test_entry_point_without_device_raises_without_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
