"""CLI entry: ``python -m repro_torch.inference`` (see harness.main)."""
from repro_torch.inference.harness import main

raise SystemExit(main())
