"""Data streams of the port (the grouped synthetic corpus)."""

from .grouped import CohortSampler, GroupedCorpus

__all__ = ["CohortSampler", "GroupedCorpus"]
