#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--generations N] [--seed S]

Phases, one JSON object per line on standard output:

1. ``device``  — the card (``nvidia-smi`` name and power limit, torch's
   device name and count).
2. ``build``   — first-use build of every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, run together), with
   ptxas' register and shared-memory report.
3. ``kernel``  — one line per kernel and shape: each kernel's wrapper on
   card tensors against its plain PyTorch version on the same inputs
   (population_lut and lut_matmul byte-equal; rank_k within rtol 1e-5,
   atol 0.5, with TF32 off), both timed with CUDA events, and for the
   population gather also the one PyTorch indexing call that computes it.
4. ``labels``  — ``default_labeler(GaussianFilter(), lib,
   n_qor_samples=4, device="cuda")`` on 1000 numpy-seeded genomes, then a
   second batch of 1000.  ``qor`` and ``energy`` must be bit-identical to
   ``device="cpu"`` on a 64-genome subset and to the per-genome numpy
   ``Accelerator.qor`` on 8 genomes.
5. ``dse``     — ``run_dse`` on ``GaussianFilter`` at the paper's widths
   (n_train=1000, pop_size=1000, n_parents=200, 4 QoR images), with
   ``n_generations`` cut as the ``reduced`` field says; the front's labels
   are checked against ``device="cpu"``.

Every kernel's launch count is set to 0 just before each of phases 4 and
5 and read just after; a kernel of the main path (``MAIN_PATH``) that the
phase did not launch fails the run.  ``lut_matmul`` is the behavioural
route of the deployment module, which the labels do not run; its rows in
phase 3 hold it against its plain version.
Then one line ``{"kernels": [...]}`` sums it up, and the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failed build,
launch or comparison exits non-zero before that line, as does a machine
without a CUDA device or a directory without the port's sources.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): HBM3 rate and
# the float32 rate of the CUDA cores (outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

RANK_RTOL, RANK_ATOL = 1e-5, 0.5     # as the JAX package's kernel tests

# kernels that labeling and run_dse launch: the population gather of every
# QoR label and the rank-k deployment graph that synthesis runs
MAIN_PATH = ("population_lut", "rank_k")


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, *, repeats: int = 20, warmup: int = 3, runs: int = 3) -> float:
    """Card time of one ``fn()``: CUDA events around a run of ``repeats``
    back-to-back calls, over the count; the median of ``runs`` such runs,
    after ``warmup`` calls.  Nothing in a call waits for the card, so the
    host queues ahead and a kernel longer than its launch is timed alone;
    a shorter one is timed at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / repeats)
    return statistics.median(times)


def bound(*, nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {
        "phase": "device", "nvidia_smi": line,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch import _build

    t0 = time.perf_counter()
    walls = _build.build()
    wall = time.perf_counter() - t0
    ptxas = {
        name: [ln.split(":", 1)[-1].strip()
               for ln in _build.build_log(name).splitlines()
               if "Used" in ln or "spill" in ln]
        for name in _build.KERNELS
    }
    emit({"phase": "build", "wall_s": wall, "nvcc_s": walls, "ptxas": ptxas})


def _kernel_row(name, case, route_src, replaces, kernel_fn, plain_fn,
                compare, nbytes, ops, repeats=20, library_fn=None):
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}[{case}]: kernel {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    err = float(torch.max(torch.abs(got.double() - want.double()))) \
        if got.numel() else 0.0
    compare(got, want, f"{name}[{case}]")
    if library_fn is not None:
        compare(library_fn(), want, f"{name}[{case}] library call")
    ms = time_ms(kernel_fn, repeats=repeats)
    plain_ms = time_ms(plain_fn, repeats=repeats)
    library_ms = (time_ms(library_fn, repeats=repeats)
                  if library_fn is not None else None)
    b_ms, b_by = bound(nbytes=nbytes, ops=ops)
    row = {"name": name, "case": case, "route": "cuda", "source": route_src,
           "replaces": replaces, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms}
    emit({"phase": "kernel", **row})
    return row


def _byte_equal(got, want, what):
    import torch

    check(torch.equal(got, want), f"{what}: kernel differs from plain version")


def _rank_close(got, want, what):
    import torch

    check(torch.allclose(got, want, rtol=RANK_RTOL, atol=RANK_ATOL),
          f"{what}: kernel outside rtol {RANK_RTOL}, atol {RANK_ATOL}")


def phase_kernels(seed: int) -> list:
    import numpy as np
    import torch

    from repro_torch.accel import GaussianFilter
    from repro_torch.accel import fused
    from repro_torch.accel.gaussian import GAUSS_COEFFS, _im2col
    from repro_torch.core.acl.library import default_library
    from repro_torch.kernels.approx_matmul import (
        from_circuit, lut_matmul, lut_matmul_kernel, rank_k_matmul,
        rank_k_matmul_kernel,
    )
    from repro_torch.kernels.population_lut import (
        population_lut_gather, population_lut_gather_ref,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    lib = default_library()
    acc = GaussianFilter()
    rows = []

    # population_lut at gaussian3x3's label widths
    src = "src/repro_torch/csrc/population_lut.cu"
    rep = "src/repro/kernels/population_lut/kernel.py:43"
    lut = fused.build_engine(lib, dev).lut("mul8u", GAUSS_COEFFS,
                                           tag=acc.name)
    C, S, _ = lut.shape
    G = 1000
    genes = torch.from_numpy(
        rng.integers(0, C, size=(G, S)).astype(np.int32)).to(dev)
    cols = torch.from_numpy(np.ascontiguousarray(
        _im2col(acc.sample_inputs(4, seed=1234)), dtype=np.int32)).to(dev)
    M = cols.shape[0]
    # the library call: one advanced-indexing gather, its int64 index
    # tensors built outside the timed region
    g_l = genes.long()[:, None, :]
    s_l = torch.arange(S, device=dev)
    for per_genome in (False, True):
        c = cols if not per_genome else torch.from_numpy(
            rng.integers(0, 256, size=(G, M, S)).astype(np.int32)).to(dev)
        c_l = c.long() if per_genome else c.long()[None]
        rows.append(_kernel_row(
            "population_lut",
            f"G={G} M={M} S={S} C={C} "
            + ("per-genome cols" if per_genome else "shared cols"),
            src, rep,
            lambda c=c, p=per_genome: population_lut_gather(
                lut, genes, c, per_genome=p),
            lambda c=c, p=per_genome: population_lut_gather_ref(
                lut, genes, c, per_genome=p),
            _byte_equal,
            nbytes=4.0 * (lut.numel() + genes.numel() + c.numel() + G * M * S),
            ops=0.0,
            library_fn=lambda c_l=c_l: lut[g_l, s_l, c_l],
        ))

    # rank_k and lut_matmul at the nine gaussian slot groups of a variant
    # covering ranks 0..4, then at larger square shapes
    names = ["mul8u_exact", "mul8u_trunc3", "mul8u_perf2", "mul8u_bam2",
             "mul8u_bam4", "mul8u_bam6", "mul8u_mitchell", "mul8u_drum4",
             "mul8u_kulkarni"]
    specs = [from_circuit(lib[n]) for n in names]
    x9 = torch.from_numpy(np.ascontiguousarray(
        _im2col(acc.sample_inputs(1, seed=1)), dtype=np.int32)).to(dev)
    w9 = torch.from_numpy(GAUSS_COEFFS.reshape(9, 1).astype(np.int32)).to(dev)
    groups = [(x9[:, g:g + 1].contiguous(), w9[g:g + 1].contiguous(), sp)
              for g, sp in enumerate(specs)]
    uv = [tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(dev)
                for t in (sp.u, sp.v)) for sp in specs]
    tabs = [torch.from_numpy(sp.table).to(dev) for sp in specs]

    def all_groups(fn):
        return lambda: torch.stack([fn(i) for i in range(9)])

    m9 = x9.shape[0]
    ranks = sum(sp.rank for sp in specs)
    src = "src/repro_torch/csrc/rank_k.cu"
    rep = "src/repro/kernels/approx_matmul/kernel.py:72"
    rows.append(_kernel_row(
        "rank_k", f"9 slot groups ({m9},1)@(1,1), ranks "
        + ",".join(str(sp.rank) for sp in specs) + " (9 launches)",
        src, rep,
        all_groups(lambda i: rank_k_matmul_kernel(
            groups[i][0], groups[i][1], *uv[i], signed=False)),
        all_groups(lambda i: rank_k_matmul(
            groups[i][0], groups[i][1], *uv[i], signed=False)),
        _rank_close,
        nbytes=9 * 4.0 * (2 * m9 + 1) + 2 * 256 * 4.0 * ranks,
        ops=2.0 * m9 * (9 + ranks),
    ))
    for signed, cname in ((False, "mul8u_bam6"), (True, "mul8s_drum4")):
        n = 1024
        r = 4
        f = lib[cname].factors(r)
        lo, hi = (-128, 128) if signed else (0, 256)
        x = torch.from_numpy(rng.integers(lo, hi, (n, n)).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(lo, hi, (n, n)).astype(np.int32)).to(dev)
        u = torch.from_numpy(np.ascontiguousarray(f.u, np.float32)).to(dev)
        v = torch.from_numpy(np.ascontiguousarray(f.v, np.float32)).to(dev)
        rows.append(_kernel_row(
            "rank_k", f"({n},{n})@({n},{n}) r={r} "
            + ("signed" if signed else "unsigned") + f" {cname}",
            src, rep,
            lambda x=x, w=w, u=u, v=v, s=signed: rank_k_matmul_kernel(
                x, w, u, v, signed=s),
            lambda x=x, w=w, u=u, v=v, s=signed: rank_k_matmul(
                x, w, u, v, signed=s),
            _rank_close,
            nbytes=4.0 * 3 * n * n + 2 * 256 * 4.0 * r,
            ops=2.0 * n ** 3 * (1 + r), repeats=10,
        ))

    src = "src/repro_torch/csrc/lut_matmul.cu"
    rep = "src/repro/kernels/approx_matmul/kernel.py:132"
    rows.append(_kernel_row(
        "lut_matmul", f"9 slot groups ({m9},1)@(1,1) (9 launches)", src, rep,
        all_groups(lambda i: lut_matmul_kernel(
            groups[i][0], groups[i][1], tabs[i], signed=False)),
        all_groups(lambda i: lut_matmul(
            groups[i][0], groups[i][1], tabs[i], signed=False)),
        _byte_equal,
        nbytes=9 * 4.0 * (65536 + 2 * m9 + 1), ops=9.0 * m9,
    ))
    for signed, cname in ((False, "mul8u_bam6"), (True, "mul8s_drum4")):
        n = 512
        lo, hi = (-128, 128) if signed else (0, 256)
        x = torch.from_numpy(rng.integers(lo, hi, (n, n)).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(lo, hi, (n, n)).astype(np.int32)).to(dev)
        t = torch.from_numpy(lib[cname].table.astype(np.int32)).to(dev)
        rows.append(_kernel_row(
            "lut_matmul", f"({n},{n})@({n},{n}) "
            + ("signed" if signed else "unsigned") + f" {cname}",
            src, rep,
            lambda x=x, w=w, t=t, s=signed: lut_matmul_kernel(x, w, t, signed=s),
            lambda x=x, w=w, t=t, s=signed: lut_matmul(x, w, t, signed=s),
            _byte_equal,
            nbytes=4.0 * (65536 + 3 * n * n), ops=float(n) ** 3, repeats=10,
        ))
    return rows


def _random_genomes(acc, lib, n: int, rng):
    import numpy as np

    sizes = acc.gene_sizes(lib)
    g = rng.integers(0, sizes[None, :], size=(n, len(sizes)))
    g[0] = acc.exact_genome(lib)
    return np.asarray(g, dtype=np.int64)


def _check_labels(labels: dict, n: int, what: str) -> None:
    import numpy as np

    from repro_torch.core.features.synth import LABEL_KEYS

    for k in LABEL_KEYS:
        v = np.asarray(labels[k])
        check(v.shape == (n,) and np.all(np.isfinite(v)),
              f"{what}: label {k} not finite of shape ({n},)")


def phase_labels(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.accel import GaussianFilter
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.dse import default_labeler

    lib = default_library()
    acc = GaussianFilter()
    rng = np.random.default_rng(seed)
    g1 = _random_genomes(acc, lib, 1000, rng)
    g2 = _random_genomes(acc, lib, 1000, rng)

    _build.reset_launches()
    labeler = default_labeler(acc, lib, n_qor_samples=4, device="cuda")
    t0 = time.perf_counter()
    lab1 = labeler(g1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lab2 = labeler(g2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)

    _check_labels(lab1, len(g1), "labels batch 1")
    _check_labels(lab2, len(g2), "labels batch 2")
    check(lab1["qor"][0] == 100.0, "exact genome's QoR is not 100.0")
    for k in MAIN_PATH:
        check(launches[k] > 0, f"labels phase launched no {k} kernel")
    sub = 64
    cpu = default_labeler(acc, lib, n_qor_samples=4, device="cpu")(g1[:sub])
    for k in ("qor", "energy"):
        check(np.array_equal(cpu[k], lab1[k][:sub]),
              f"cuda {k} differs from cpu on the {sub}-genome subset")
    inputs = acc.sample_inputs(4, seed=1234)
    for t in range(8):
        circuits, _ = acc.decode(g1[t], lib)
        check(acc.qor(circuits, inputs) == lab1["qor"][t],
              f"cuda qor of genome {t} differs from the per-genome numpy qor")
    out = {
        "phase": "labels", "genomes": [len(g1), len(g2)],
        "first_s": t1 - t0, "second_s": t2 - t1,
        "first_labels_per_s": len(g1) / (t1 - t0),
        "second_labels_per_s": len(g2) / (t2 - t1),
        "sim_s": [float(lab1["sim_time"].sum()), float(lab2["sim_time"].sum())],
        "synth_s": [float(lab1["synth_time"].sum()),
                    float(lab2["synth_time"].sum())],
        "cpu_subset_bit_identical": {"genomes": sub, "keys": ["qor", "energy"]},
        "launches": launches,
    }
    emit(out)
    return out


def phase_dse(generations: int) -> dict:
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.accel import GaussianFilter
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.dse import DSEConfig, default_labeler, run_dse
    from repro_torch.core.nsga2 import NSGA2Config

    lib = default_library()
    acc = GaussianFilter()
    # the JAX package's default power surrogate (bayesian_ridge) hits a
    # singular system on 1000 labels of this accelerator: its energy is
    # an exact linear function of the features.  Ridge regularizes.
    cfg = DSEConfig(
        n_train=1000, n_qor_samples=4, hw_model="ridge",
        nsga=NSGA2Config(pop_size=1000, n_parents=200,
                         n_generations=generations),
    )
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_dse(acc, lib, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    for k in MAIN_PATH:
        check(launches[k] > 0, f"dse phase launched no {k} kernel")
    front_g = res.front_genomes
    front_o = res.front_objectives
    check(len(front_g) > 0 and np.all(np.isfinite(front_o)),
          "dse front empty or not finite")
    cpu = default_labeler(acc, lib, n_qor_samples=4, device="cpu")(front_g)
    check(np.array_equal(-cpu["qor"], front_o[:, 0])
          and np.array_equal(cpu["energy"], front_o[:, 1]),
          "dse front objectives differ from a cpu re-label")
    out = {
        "phase": "dse", "accel": acc.name, "wall_s": wall,
        "n_train": cfg.n_train, "pop_size": cfg.nsga.pop_size,
        "n_parents": cfg.nsga.n_parents, "n_qor_samples": cfg.n_qor_samples,
        "reduced": {"n_generations": {"paper": 1000, "repo_default": 100,
                                      "run": generations},
                    "hw_model": {"repo_default": "bayesian_ridge",
                                 "run": "ridge"}},
        "front_size": int(len(front_g)),
        "front_qor_range": [float(-front_o[:, 0].max()),
                            float(-front_o[:, 0].min())],
        "val_pcc": res.val_pcc, "timings_s": res.timings,
        "launches": launches,
    }
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generations", type=int, default=100,
                    help="NSGA-II generations of the dse phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    try:
        info = phase_device()
        phase_build()
        rows = phase_kernels(args.seed)
        labels = phase_labels(args.seed)
        dse = phase_dse(args.generations)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "repro")
                    or m.startswith(("jax.", "repro.")))
    if leaked:
        print(f"chip_smoke: FAIL: imported {leaked[:5]}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = (labels["launches"][row["name"]]
                           + dse["launches"][row["name"]])
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
