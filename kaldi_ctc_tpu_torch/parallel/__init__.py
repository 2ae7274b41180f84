"""Process mesh and sharding rules for multi-process training
(counterpart of kaldi_ctc_tpu/parallel): ``distributed`` joins the
``torch.distributed`` group, ``mesh`` places this process in it."""

from kaldi_ctc_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    param_sharding,
    replicated,
    shard_batch,
)
