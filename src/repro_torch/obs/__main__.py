"""Alias: ``python -m repro_torch.obs`` == ``python -m repro_torch.obs.export``."""

from .export import main

raise SystemExit(main())
