"""Synthetic data (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import Prefetcher, SyntheticAE, SyntheticLM

__all__ = ["SyntheticLM", "SyntheticAE", "Prefetcher"]
