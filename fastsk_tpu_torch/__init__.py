"""fastsk-tpu's exact-kernel path in PyTorch, with CUDA kernels for Hopper.

A port of ``fastsk_tpu`` (JAX) that mirrors its layout and names. This
first slice covers the exact workflow: read FASTA, compute the exact
gapped k-mer kernel with the sequence-aligned all-pairs engine (kernel A,
``csrc/pairs.cu``), cosine-normalize it, fit a C-SVC with Platt
probabilities (kernel B, ``csrc/smo.cu``) and score AUC::

    from fastsk_tpu_torch import FastSK, FastaUtility, KernelConfig

    reader = FastaUtility()
    Xtrain, Ytrain = reader.read_data("train.fasta")
    Xtest, Ytest = reader.read_data("test.fasta")
    fsk = FastSK(g=8, m=4, config=KernelConfig(device_resident=True))
    fsk.compute_kernel(Xtrain, Xtest, Ytrain, Ytest)
    fsk.fit(C=1.0)
    print(fsk.score("auc"))

The kernels are compiled with nvcc at first use into
``build/fastsk_tpu_torch/``. On the CPU (``KernelConfig(device="cpu")``)
their plain PyTorch versions run instead. This package imports no jax.
"""

from .api import FastSK
from .io.fasta import FastaUtility, Vocabulary
from .kernel.config import KernelConfig

__version__ = "0.1.0"

__all__ = ["FastSK", "FastaUtility", "Vocabulary", "KernelConfig", "__version__"]
