"""Checkpoint reading (counterpart of kaldi_ctc_tpu/training)."""
