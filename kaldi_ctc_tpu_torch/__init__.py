"""kaldi_ctc_tpu_torch — the PyTorch/CUDA port of kaldi_ctc_tpu.

A second package beside ``kaldi_ctc_tpu/`` with the same layout
(``features/``, ``ops/``, ``models/``, ``training/``, ``decoding/``,
``utils/``, ``cli/``), so each module's counterpart sits at the same
relative path.  It imports ``torch`` and never ``jax`` or
``kaldi_ctc_tpu``.  Plain tensor code is PyTorch; every TPU kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built at first
use by ``_kernels.py``.

Importing the package starts nothing and reads no file; it only pins the
float32 numerics below.
"""

import torch

# Hazard F2: TF32 keeps ~3 decimal digits.  The DFT of the log-mel front
# end cancels heavily and the JAX reference computes it (and every f32
# matmul it compares against) at full IEEE f32, so the port pins IEEE f32
# for matmuls and cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
