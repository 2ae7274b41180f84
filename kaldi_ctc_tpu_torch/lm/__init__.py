"""Lexicon only (kaldi_ctc_tpu/lm's arpa and const_arpa: ROADMAP item 15)."""

from kaldi_ctc_tpu_torch.lm.lexicon import (  # noqa: F401
    add_lex_disambig,
    labels_from_text,
    lexicon_to_fst_arrays,
    parse_lexicon,
)
