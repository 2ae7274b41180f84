"""Examples, bucketing, egs archives and the host prefetch pipeline
(counterpart of kaldi_ctc_tpu/data)."""

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
from kaldi_ctc_tpu_torch.data.pipeline import (  # noqa: F401
    EgsPipeline,
    Prefetcher,
    load_examples,
)
