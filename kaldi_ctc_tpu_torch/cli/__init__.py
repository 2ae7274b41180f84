"""Command-line entry points (counterpart of kaldi_ctc_tpu/cli)."""
