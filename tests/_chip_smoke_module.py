"""``chip_smoke.py`` imported as the module ``chip_smoke`` by the tests
that run its figure phases on the CPU."""

import importlib.util
import sys
from pathlib import Path


def load_chip_smoke():
    """The script as the module ``chip_smoke``, registered so that the
    processes ``_fig6`` spawns can unpickle its functions by name (they
    import it from the repo root, put on their path)."""
    if "chip_smoke" in sys.modules:
        return sys.modules["chip_smoke"]
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    return mod
