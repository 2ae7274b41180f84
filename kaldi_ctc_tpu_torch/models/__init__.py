"""Acoustic model and inference artifacts (counterpart of kaldi_ctc_tpu/models)."""

from kaldi_ctc_tpu_torch.models.acoustic import (  # noqa: F401
    AmConfig,
    am_forward,
    default_priors,
    grow_rnn_layer,
    init_am_params,
)
