"""Training step, optimizer semantics, checkpointing (counterpart of
kaldi_ctc_tpu/training)."""

from kaldi_ctc_tpu_torch.training.train import (  # noqa: F401
    TrainOptions,
    TrainState,
    accuracy_from_outputs,
    build_train_step,
    exponential_lr,
    init_train_state,
    make_eval_step,
    make_train_step,
)
