"""Dump the composed (pre-determinize) LG for a synth language to disk.

Counterpart of ``tools/dump_lg.py``: the same host code over the port's
modules, runnable as ``python -m kaldi_ctc_tpu_torch.tools.dump_lg
[vocab] [seed]``.

Profiling/diagnostic helper for the native determinize-star work: writes
``lg_v{vocab}.fst`` (OpenFst binary) to the temporary directory (``/tmp``
unless ``TMPDIR`` says otherwise) so the C++ harness can iterate on
DeterminizeStar without re-running the Python front half.
"""
import io
import os
import sys
import tempfile
import time

from kaldi_ctc_tpu_torch.data.synth_lang import make_language
from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst
from kaldi_ctc_tpu_torch.lm import arpa_to_fst_arrays, parse_arpa
from kaldi_ctc_tpu_torch.lm.lexicon import (add_lex_disambig,
                                            lexicon_to_fst_arrays)


def main(vocab: int, seed: int = 0) -> str:
    t0 = time.perf_counter()
    lang = make_language(vocab=vocab, seed=seed)
    lm = parse_arpa(io.StringIO(lang.arpa_text))
    phone_to_id = {f"p{i:02d}": i for i in range(1, lang.num_phones + 1)}
    lexicon, num_disambig = add_lex_disambig(lang.lexicon)
    l_start, l_n, l_arcs, l_w, l_fin, phone_to_id, word_to_id = \
        lexicon_to_fst_arrays(lexicon, phone_to_id=phone_to_id,
                              sil_phone=None, sil_prob=0.5)
    L = NativeFst.from_arrays(l_start, l_n, l_arcs, l_w, l_fin)
    g_start, g_n, g_arcs, g_w, g_fin, word_to_id = \
        arpa_to_fst_arrays(lm, dict(word_to_id))
    G = NativeFst.from_arrays(g_start, g_n, g_arcs, g_w, g_fin)
    LG = L.compose(G)
    path = os.path.join(tempfile.gettempdir(), f"lg_v{vocab}.fst")
    LG.write(path)
    print(f"vocab={vocab} disambig={num_disambig} "
          f"LG states={LG.num_states} arcs={LG.num_arcs} "
          f"front_s={time.perf_counter() - t0:.1f} -> {path}")
    return path


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5000,
         int(sys.argv[2]) if len(sys.argv) > 2 else 0)
