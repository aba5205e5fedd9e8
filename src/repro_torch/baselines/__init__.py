"""The paper's Section-5 comparison set (port of ``repro.baselines``):

* ``exact_cd`` -- LIBSVM analogue: whole-problem greedy CD + shrinking
  from zero;
* ``cascade`` -- CascadeSVM [Graf et al., 2005]: a random binary partition
  tree, only SVs propagate upward;
* ``nystrom`` -- LLSVM [Zhang et al., 2008; Wang et al., 2011]: a k-means
  Nystrom feature map + a linear SVM;
* ``rff`` -- FastFood/RFF analogue [Le et al., 2013]: random Fourier
  features + a linear SVM;
* ``ltpu`` -- Locally-Tuned Processing Units [Moody & Darken, 1989].

(BCM prediction is in ``repro_torch.core.predict``.)  Every ``train_*``
runs on ``device`` (default ``cuda``), through the CUDA kernels there
unless ``use_kernels=False``, and takes the reference's random draws as
arguments (``init_idx``; RFF's ``normal`` and ``uniform``).
"""
from repro_torch.baselines.cascade import CascadeSVM, train_cascade
from repro_torch.baselines.exact_cd import ExactSVM, train_exact
from repro_torch.baselines.ltpu import LTPU, train_ltpu
from repro_torch.baselines.nystrom import LLSVM, train_llsvm
from repro_torch.baselines.rff import RFFSVM, train_rff

__all__ = ["CascadeSVM", "ExactSVM", "LLSVM", "LTPU", "RFFSVM",
           "train_cascade", "train_exact", "train_llsvm", "train_ltpu",
           "train_rff"]
