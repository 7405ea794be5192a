"""Alias for the reference's ``fastsk.utils`` module surface
(src/fastsk/utils.py: Vocabulary :11-14, FastaUtility :50-96).
"""

from fastsk_jax.io.fasta import FastaUtility, Vocabulary

__all__ = ["FastaUtility", "Vocabulary"]
