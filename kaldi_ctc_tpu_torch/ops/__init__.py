"""Recurrent stacks and their CUDA kernels (counterpart of kaldi_ctc_tpu/ops)."""
