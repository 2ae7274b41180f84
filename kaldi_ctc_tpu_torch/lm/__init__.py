"""Language models: ARPA parsing, scoring, and G.fst compilation; the
lexicon (counterpart of kaldi_ctc_tpu/lm)."""

from kaldi_ctc_tpu_torch.lm.arpa import (  # noqa: F401
    ArpaLm,
    arpa_to_fst_arrays,
    parse_arpa,
    sentence_logprob,
)
from kaldi_ctc_tpu_torch.lm.lexicon import (  # noqa: F401
    add_lex_disambig,
    labels_from_text,
    lexicon_to_fst_arrays,
    parse_lexicon,
)
