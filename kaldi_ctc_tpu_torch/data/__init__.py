"""Examples, bucketing and egs archives (counterpart of kaldi_ctc_tpu/data).

``data/pipeline.py`` (the host prefetch pipeline) is not ported yet:
ROADMAP.md item 8."""

from kaldi_ctc_tpu_torch.data.egs import (  # noqa: F401
    MAX_LABEL_LENGTH,
    CtcExample,
    collapse_alignment,
    example_ok,
    frame_subsample,
)
from kaldi_ctc_tpu_torch.data.bucketing import (  # noqa: F401
    batch_by_length,
    bucket_length,
    make_buckets,
    pad_batch,
)
