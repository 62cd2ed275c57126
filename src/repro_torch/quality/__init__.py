"""repro_torch.quality - the Crush-lite battery over the port's surfaces.

The paper's headline claim is not throughput alone: ThundeRiNG passes
TestU01 while cheap decorrelation keeps unlimited streams independent
(paper Sec. 6, Tables 2-4).  This package is the port's form of that
claim:

  * ``crush``   - per-block SmallCrush-style tests with TestU01-style
    two-level aggregation (numpy, the reference's),
  * ``cross``   - the inter-stream battery (pairwise-correlation sweep
    and interleaved-pair sub-battery; numpy, the reference's),
  * ``pit``     - the probability integral transform that reduces the
    distribution stages to uniform words,
  * ``battery`` - ``run_battery``: draws through the port's
    ``engine.generate`` / ``generate_sharded`` / leased ``BlockService``
    windows / ``Coalescer`` on a device and returns a report of the
    reference's schema,
  * ``render``  - the report as markdown.

Public surface: ``run_battery`` (and the profile registry ``PROFILES``).
"""
from repro_torch.quality.battery import (DEFAULT_SEED, PROFILES, Profile,
                                         run_battery)

__all__ = ["DEFAULT_SEED", "PROFILES", "Profile", "run_battery"]
