"""Kaldi-compatible feature front end on PyTorch (the serving slice).

Counterpart of ``kaldi_ctc_tpu/features``: framing, windowing, the fused
log-mel stage (CUDA kernel K4, ``stft_cuda.py``), MFCC, fbank and CMVN,
plus host-only copies of the wave reader, resampler and mel banks.
"""

from kaldi_ctc_tpu_torch.features.window import (  # noqa: F401
    FrameOptions,
    feature_window,
    frame_signal,
    num_frames,
    process_frames,
)
from kaldi_ctc_tpu_torch.features.mel import MelOptions, mel_banks  # noqa: F401
from kaldi_ctc_tpu_torch.features.mfcc import (  # noqa: F401
    MfccOptions,
    compute_mfcc,
)
from kaldi_ctc_tpu_torch.features.fbank import (  # noqa: F401
    FbankOptions,
    compute_fbank,
)
from kaldi_ctc_tpu_torch.features.cmvn import (  # noqa: F401
    acc_cmvn_stats,
    apply_cmvn,
)
from kaldi_ctc_tpu_torch.features.wave import read_wave  # noqa: F401
