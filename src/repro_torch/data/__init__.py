"""Data substrate: synthetic/file token pipelines with host sharding
(numpy only, the reference's module as it stands)."""

from repro_torch.data.pipeline import (DataConfig, Prefetcher, SyntheticLM,
                                       TokenFile, make_pipeline)

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "TokenFile", "make_pipeline"]
