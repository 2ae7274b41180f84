"""Score preparation and streaming recognition (counterpart of
kaldi_ctc_tpu/decoding)."""
