"""fastsk-jax: a gapped k-mer string kernel engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of QData/FastSK
(Bioinformatics 2020): gapped k-mer (gkm) string kernels over DNA / protein /
text sequences, Monte-Carlo approximation with on-line convergence, and an
SVM stack — built as matrix programs for accelerators (count-matmuls, a
fused Pallas kernel on NVIDIA GPUs, mesh sharding) rather than translated
from the reference's C++/pthreads.

Public surface mirrors the reference Python API::

    from fastsk_jax import FastSK, FastaUtility

    reader = FastaUtility()
    Xtrain, Ytrain = reader.read_data("train.fasta")
    Xtest, Ytest = reader.read_data("test.fasta")
    fastsk = FastSK(g=10, m=6, approx=True)
    fastsk.compute_kernel(Xtrain, Xtest)
    K_train = fastsk.get_train_kernel()
"""

from .api import FastSK
from .io.fasta import FastaUtility, Vocabulary
from .kernel.config import KernelConfig

__version__ = "0.1.0"

__all__ = ["FastSK", "FastaUtility", "Vocabulary", "KernelConfig", "__version__"]
