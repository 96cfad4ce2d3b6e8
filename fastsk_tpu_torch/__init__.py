"""fastsk-tpu's exact-kernel workflow in PyTorch, with CUDA kernels for Hopper.

A port of ``fastsk_tpu`` (JAX) that mirrors its layout and names. It
covers the exact workflow: read FASTA, compute the exact gapped k-mer
kernel with the sequence-aligned all-pairs engine (kernel A,
``csrc/pairs.cu``) or, on ragged sets, the packed engine (kernels D, E,
G, ``csrc/pairs_packed.cu``), cosine-normalize it, and fit any SVM of the
LIBSVM family on it: C-SVC with Platt probabilities, epsilon-SVR and
one-class on Solver::Solve (kernel B, ``csrc/smo.cu``), nu-SVC and nu-SVR
on Solver_NU (kernel C, same file), and one-vs-one for multiclass
labels::

    from fastsk_tpu_torch import FastSK, FastaUtility, KernelConfig

    reader = FastaUtility()
    Xtrain, Ytrain = reader.read_data("train.fasta")
    Xtest, Ytest = reader.read_data("test.fasta")
    fsk = FastSK(g=8, m=4, config=KernelConfig(device_resident=True))
    fsk.compute_kernel(Xtrain, Xtest, Ytrain, Ytest)
    fsk.fit(C=1.0)                     # or svm_type="nu_svc", nu=0.5, ...
    print(fsk.score("auc"))

The command lines are ``fastsk-torch`` (``python -m fastsk_tpu_torch.cli``)
and ``fastsk-torch-predict`` (``python -m fastsk_tpu_torch.predict_cli``).
The kernels are compiled with nvcc at first use into
``build/fastsk_tpu_torch/``. On the CPU (``KernelConfig(device="cpu")``)
their plain PyTorch versions run instead. This package imports no jax.
"""

from .api import FastSK
from .io.fasta import FastaUtility, Vocabulary
from .kernel.config import KernelConfig
from .svm.kernel_svm import EpsilonSVR, KernelSVC, NuSVC, NuSVR, OneClassSVM

__version__ = "0.1.0"

__all__ = [
    "FastSK", "FastaUtility", "Vocabulary", "KernelConfig", "KernelSVC",
    "NuSVC", "NuSVR", "EpsilonSVR", "OneClassSVM", "__version__",
]
