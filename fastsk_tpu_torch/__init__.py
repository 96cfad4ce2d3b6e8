"""fastsk-tpu in PyTorch, with CUDA kernels for Hopper.

A port of ``fastsk_tpu`` (JAX) that mirrors its layout and names, and does
what it does:

- the exact gapped k-mer kernel: the sequence-aligned all-pairs engine
  (kernel A, ``csrc/pairs.cu``) on uniform lengths, the packed engine
  (kernels D, E, G, ``csrc/pairs_packed.cu``) on ragged sets, or the dense
  and sorted theta engines (``kernel/engine.py``,
  ``kernel/sorted_engine.py``; torch ops, no kernel of their own);
- approx mode (``FastSK(approx=True)``): the reference's Monte-Carlo
  Welford stop on the theta engines, deterministic given ``seed``;
- multi-device and multi-process runs over a ``(rows, theta)`` mesh
  (``parallel/``; the packed engine's ring and round-robin strips on kernel
  F) and checkpoint/resume of theta runs (``utils/checkpoint.py``);
- the LIBSVM family on the kernel: C-SVC with Platt probabilities,
  epsilon-SVR and one-class on Solver::Solve (kernel B, ``csrc/smo.cu``),
  nu-SVC and nu-SVR on Solver_NU (kernel C), one-vs-one for multiclass;
- the empirical-kernel-map workflow behind the published numbers: linear
  SVMs on kernel rows (``svm/linear.py``: ``LinearSVC``,
  ``CalibratedLinearSVC``, ``MulticlassLinearSVC``), ``Lasso`` /
  ``LassoCV`` for regression (``svm/lasso.py``), and the runners
  (``harness/``) with their TSV readers (``io/readers.py``) and baseline
  tool wrappers;
- the CharCNN and LSTM baselines (``models/``, ``train_model``);
- progress, timing and ``torch.profiler`` traces (``utils/observe.py``,
  ``KernelConfig.profile_dir``) and the H100 roofline accounting
  (``utils/roofline.py``)::

    from fastsk_tpu_torch import FastSK, FastaUtility, KernelConfig

    reader = FastaUtility()
    Xtrain, Ytrain = reader.read_data("train.fasta")
    Xtest, Ytest = reader.read_data("test.fasta")
    fsk = FastSK(g=8, m=4, config=KernelConfig(device_resident=True))
    fsk.compute_kernel(Xtrain, Xtest, Ytrain, Ytest)
    fsk.fit(C=1.0)                     # or svm_type="nu_svc", nu=0.5, ...
    print(fsk.score("auc"))

The command lines are ``fastsk-torch`` (``python -m fastsk_tpu_torch``)
and ``fastsk-torch-predict`` (``python -m fastsk_tpu_torch.predict_cli``).
The kernels are compiled with nvcc at first use into
``build/fastsk_tpu_torch/``. Everything runs on the card by default; on the
CPU (``KernelConfig(device="cpu")``, or ``device="cpu"``) the kernels'
plain PyTorch versions run instead. This package imports no jax.
"""

from .api import FastSK
from .io.fasta import FastaUtility, Vocabulary
from .kernel.config import KernelConfig
from .svm.kernel_svm import EpsilonSVR, KernelSVC, NuSVC, NuSVR, OneClassSVM
from .svm.lasso import Lasso, LassoCV
from .svm.linear import CalibratedLinearSVC, LinearSVC

__version__ = "0.1.0"

__all__ = [
    "FastSK", "FastaUtility", "Vocabulary", "KernelConfig", "KernelSVC",
    "NuSVC", "NuSVR", "EpsilonSVR", "OneClassSVM", "LinearSVC",
    "CalibratedLinearSVC", "Lasso", "LassoCV", "__version__",
]
