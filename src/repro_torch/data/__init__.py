from repro_torch.data.pipeline import LeasedBatchFeeder, SyntheticLMPipeline

__all__ = ["LeasedBatchFeeder", "SyntheticLMPipeline"]
