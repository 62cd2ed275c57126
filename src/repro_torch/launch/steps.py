"""Step functions of the serving path.

Only ``make_serve_fns`` is ported yet; ``make_train_step`` and the
sharding plumbing (``param_sharding_tree``, ``batch_sharding``,
``opt_sharding_like``) come with the training substrate and the dry run
(ROADMAP.md queue A items 6 and 8).
"""
from __future__ import annotations

from repro_torch.models import registry


def make_serve_fns(model: registry.Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    def decode_step(params, cache, token, pos):
        return model.decode(params, cache, token, pos)

    return prefill_step, decode_step
