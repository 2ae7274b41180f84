"""Kaldi-compatible feature front end on PyTorch.

Counterpart of ``kaldi_ctc_tpu/features``: framing, windowing, the fused
log-mel stage (CUDA kernel K4, ``stft_cuda.py``), MFCC, fbank, PLP,
spectrogram, CMVN, deltas and splicing on the waveform's device, plus
host-only copies of the wave reader, resampler, mel banks, pitch, HTK
I/O and feature transforms.
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
from kaldi_ctc_tpu_torch.features.functions import (  # noqa: F401
    add_deltas,
    splice_frames,
)
from kaldi_ctc_tpu_torch.features.htk import read_htk, write_htk  # noqa: F401
from kaldi_ctc_tpu_torch.features.plp import PlpOptions, compute_plp  # noqa: F401
from kaldi_ctc_tpu_torch.features.spectrogram import (  # noqa: F401
    SpectrogramOptions,
    compute_spectrogram,
)
from kaldi_ctc_tpu_torch.features.pitch import (  # noqa: F401
    PitchOptions, ProcessPitchOptions, compute_and_process_pitch,
    compute_kaldi_pitch, process_pitch)
