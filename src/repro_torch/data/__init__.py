"""Data streams of the port: the grouped synthetic corpus and the flat
synthetic LM stream."""

from .grouped import CohortSampler, GroupedCorpus
from .synthetic import SyntheticLMStream, synthetic_lm_batch

__all__ = ["CohortSampler", "GroupedCorpus", "SyntheticLMStream",
           "synthetic_lm_batch"]
