"""Host-only helpers copied from kaldi_ctc_tpu/utils: Kaldi-format I/O,
transition models, edit distance, logging, config, section profiling."""

from kaldi_ctc_tpu_torch.utils.logging import get_logger  # noqa: F401
from kaldi_ctc_tpu_torch.utils.options import expand_config_args  # noqa: F401
