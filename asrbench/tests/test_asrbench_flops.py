"""Operations and bytes against hand counts at small shapes."""

import pytest

from asrbench import flops


def _cfg(mode, d=3, h=2, layers=2, a=5, bi=1):
    return {"rnn_mode": mode, "input_dim": d, "hidden_dim": h,
            "num_layers": layers, "num_targets": a, "bidirectional": bi,
            "compute_dtype": "float32"}


def test_forward_flops_hand_count():
    # LSTM, D=3, H=2, 2 layers, 2 directions, 5 targets.  Layer 1 a
    # direction: x W_x 2*3*8 = 48, h W_h 2*2*8 = 32; layer 2 (input 4):
    # 2*4*8 = 64 and 32; output 2*4*5 = 40.
    assert flops.forward_flops_per_frame(_cfg(2)) == 2 * (48 + 32) \
        + 2 * (64 + 32) + 40
    # GRU: 3 gates, 6 columns: layer 1 36 + 24, layer 2 48 + 24
    assert flops.forward_flops_per_frame(_cfg(3)) == 2 * (36 + 24) \
        + 2 * (48 + 24) + 40
    assert flops.train_flops_per_frame(_cfg(2)) == 3 * 392


def test_flagship_flops_per_frame():
    cfg = _cfg(2, d=40, h=320, layers=5, a=72)
    assert flops.train_flops_per_frame(cfg) == pytest.approx(64.78848e6)


def test_recurrent_work_hand_count():
    # one LSTM layer, one direction, H=2, frames 3 + 1 = 4: forward
    # products 4 * 2*2*8 = 128; bytes per direction: frames * (8 + 2) * 4
    # = 160 plus W_h 2*8*4 = 64
    cfg = _cfg(2, layers=1, bi=0)
    w = flops.recurrent_work(cfg, [3, 1], backward=False)
    assert w == {"flops": 128.0, "bytes": 224.0}
    wb = flops.recurrent_work(cfg, [3, 1], backward=True)
    assert wb == {"flops": 256.0, "bytes": 448.0}
    assert flops.least_seconds(w, 64.0, 448.0) == 2.0
    assert flops.least_seconds(w, 128.0, 112.0) == 2.0


def test_peaks_of_the_card():
    p = flops.peaks_for("NVIDIA H100 80GB HBM3", "float32")
    assert p == {"flops": 67e12, "bytes": 3.35e12}
    with pytest.raises(KeyError):
        flops.peaks_for("NVIDIA A100", "float32")
