"""Score preparation for decoding (counterpart of kaldi_ctc_tpu/decoding)."""
