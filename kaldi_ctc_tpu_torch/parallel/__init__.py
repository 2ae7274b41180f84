"""Device placement for training (counterpart of kaldi_ctc_tpu/parallel).

A one-process, one-device stand-in until ROADMAP.md item 14 ports the
multi-GPU runtime onto ``torch.distributed``: ``make_mesh`` returns the
device and ``shard_batch`` moves a numpy batch onto it.
"""

from kaldi_ctc_tpu_torch.parallel.distributed import (  # noqa: F401
    make_mesh,
    shard_batch,
)
