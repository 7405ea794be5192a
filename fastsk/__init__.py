"""Drop-in alias for the reference package name.

The reference exposes ``from fastsk import FastSK, FastaUtility``
(src/fastsk/__init__.py:1-2); this package lets that exact import run
against the JAX engine so existing scripts, notebooks, and the
reference's own test/harness code work unmodified. Everything re-exports
from :mod:`fastsk_jax` — see that package for the real implementation.
"""

from fastsk_jax import FastSK, FastaUtility, KernelConfig, Vocabulary
from fastsk_jax import __version__

__all__ = ["FastSK", "FastaUtility", "Vocabulary", "KernelConfig", "__version__"]
