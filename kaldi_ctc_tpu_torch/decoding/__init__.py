"""Decoders: greedy best-path, batched CTC prefix beam search, score
preparation and streaming recognition (counterpart of
kaldi_ctc_tpu/decoding).

The WFST TLG decoder lives in native code (``native/``) consuming
``acoustic_scores`` and its skip mask; see ``decoding/wfst``.
"""

from kaldi_ctc_tpu_torch.decoding.greedy import greedy_decode  # noqa: F401
from kaldi_ctc_tpu_torch.decoding.prefix_beam import (  # noqa: F401
    prefix_beam_search)
from kaldi_ctc_tpu_torch.decoding.scores import acoustic_scores  # noqa: F401
