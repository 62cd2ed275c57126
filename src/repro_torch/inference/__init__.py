"""Continuous-batching inference tier: slot-based decode serving with
in-kernel bits-to-token sampling.

  * ``kernels``   - kernel F, the fused gumbel-max CUDA kernel (counter
    bits -> token ids in one launch), its plain version and the two-pass
    oracle;
  * ``sampling``  - :class:`GumbelMaxSampler`: one leased counter
    window + one engine call per decode step, journaled;
  * ``slots``     - :class:`SlotPool`: live sequences as tenants,
    slot churn as deterministic region retire-and-reuse;
  * ``scheduler`` - :class:`ContinuousBatcher`: Poisson arrivals from
    the service's own ``exponential`` stage, admission, per-step churn;
  * ``harness``   - the offline benchmark + crash-replay CLI
    (``python -m repro_torch.inference``).
"""
from repro_torch.inference.sampling import (ActiveSeq,  # noqa: F401
                                            GumbelMaxSampler, SamplingSpec)
from repro_torch.inference.slots import Sequence, SlotPool  # noqa: F401
from repro_torch.inference.scheduler import (ContinuousBatcher,  # noqa: F401
                                             ScheduleConfig, RunResult,
                                             SyntheticLogitModel,
                                             transcript_digest)
from repro_torch.inference.harness import (OfflineReport,  # noqa: F401
                                           run_offline)
